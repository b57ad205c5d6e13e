"""Tiny sizes of the cells, for the CPU rehearsals: the ``lut`` plan (the
``cuda`` plan's numbers, from plain PyTorch), fewer layers and narrower
LM widths, small batches and pools.  The streams keep KWT-1's 12 layers
and run 3 s, so that most checked windows are full: with 2 layers, or
windows still mostly empty, a broken hop moves the scores less than the
cell's limits."""

KWT = {"n_layers": 2}
LM = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
      "head_dim": 16, "d_ff": 128, "vocab_size": 256}
CASES = {
    "kwt1.bulk": {"model_overrides": KWT,
                  "param_overrides": {"batch": 8, "pool_windows": 64,
                                      "ref_rows": 8}},
    "kwt1.streams": {"model_overrides": {}, "seconds": 3.0,
                     "param_overrides": {"lanes": 16, "pool_streams": 3,
                                         "pool_hops": 300, "min_hops": 100,
                                         "max_hops": 200, "warm_steps": 0}},
    "internlm2.score_8k": {"model_overrides": LM,
                           "param_overrides": {"seq_len": 384, "pool": 8}},
    "internlm2.score_1k": {"model_overrides": LM,
                           "param_overrides": {"batch": 2, "seq_len": 256,
                                               "pool": 8}},
}


def context(spec, cell: str, seed: int = 2**31 + 5, plan=None, **more):
    from bench.core import runner
    case = CASES[cell]
    return runner.context(
        spec, cell, seed, "cpu", plan={"backend": "lut", **(plan or {})},
        model_overrides={**case["model_overrides"],
                         **more.pop("model_overrides", {})},
        param_overrides={**case["param_overrides"],
                         **more.pop("param_overrides", {})})


def run(spec, cell: str, seconds: float | None = None, trace: bool = False,
        cell_class=None, after_setup=None, **kw) -> dict:
    import time

    from bench.core import runner
    if seconds is None:
        seconds = CASES[cell].get("seconds", 0.3)
    return runner.run(context(spec, cell, **kw), seconds, trace,
                      time.perf_counter(), cell_class,
                      after_setup=after_setup)
