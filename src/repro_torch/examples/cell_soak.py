"""Cell soak: lane churn + in-flight QAT-artifact hot-swap, zero drops.

The smoke test of ``repro_torch.cell``.  One process plays the whole
fleet lifecycle:

1. train a float KWT-Tiny briefly, QAT fine-tune, and EXPORT the packed
   int8 artifact (``repro_torch.qat.export``) — the serving cell boots on
   it (``lut`` backend, integer-resident weights);
2. serve ``--streams`` synthetic keyword streams of random lengths
   through a ``ServeCell`` with fewer lanes than streams, so lanes churn
   (join/evict mid-run) the whole time;
3. one third of the way in, QAT fine-tunes a few MORE steps and
   publishes the fresh export through ``checkpoint.manager`` into the
   cell's watch directory; the cell's watcher picks it up mid-traffic
   and hot-swaps it behind the probe-parity gate;
4. exit non-zero unless: the swap happened (generation bumped), post-swap
   probe logits are bit-identical to a fresh same-flavour plan of the
   swapped artifact and inside the activation-quant envelope of its
   dequantise-first reference, every admitted stream ran to completion, and
   the ingested-hop ledger reconciles EXACTLY with the offered source
   hops (``cell_hops_total`` == sum of stream lengths, zero drops across
   churn and the swap).

Run:  PYTHONPATH=src python -m repro_torch.examples.cell_soak [--streams 10]
          [--slots 4] [--telemetry-out soak_trace.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch import cell as cellmod
from repro_torch import qat, runtime, telemetry
from repro_torch.checkpoint import manager
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.examples._common import add_device_arg, plan
from repro_torch.launch import serve_common, steps
from repro_torch.launch.stream_serve import train_params
from repro_torch.stream import detector as det
from repro_torch.stream import features


def qat_artifact(cfg, params, n_steps, seed, device):
    """A few QAT steps + export: the packed int8 deploy artifact."""
    spec = qat.QATSpec(recipe=runtime.QuantRecipe.from_config(cfg))
    params, qstate = qat.finetune_qat(cfg, params, spec, n_steps, seed=seed,
                                      device=device)
    return qat.export(params, spec, qstate), params


def train(cfg, fcfg, args, device, init=None):
    """[1] the float model and the boot artifact, and the publisher of
    [3]: ``(ex1.qparams, publish)`` where ``publish()`` QAT fine-tunes the
    boot run's weights further and returns ``(qparams, rom_bytes)``."""
    fparams = train_params(cfg, fcfg, args.train_steps, args.seed, device,
                           init=init)
    ex1, fparams = qat_artifact(cfg, fparams, args.qat_steps, args.seed,
                                device)

    def publish():
        ex2, _ = qat_artifact(cfg, fparams, args.qat_steps, args.seed + 1,
                              device)
        return ex2.qparams, ex2.quantized_bytes[0]

    return ex1.qparams, publish


def sources_for(args, fcfg) -> dict:
    """The streams: a length drawn per stream, its keyword audio."""
    rng = np.random.RandomState(args.seed)
    sources = {}
    for sid in range(args.streams):
        hops = int(rng.randint(max(args.hops // 2, 2), args.hops * 2))
        audio, _ = pipeline.keyword_event_stream(
            args.seed, sid, n_hops=hops, hop_len=fcfg.hop_len)
        sources[sid] = {"audio": audio, "hops": hops}
    return sources


def soak(cfg, qparams1, publish, args, device) -> dict:
    """[2]–[4]: serve the streams on the boot artifact, publish the next
    one a third of the way in, then the acceptance ledger.  Returns
    ``{"rc", "failures", "hops", "offered_hops", "swaps", "generation",
    "probe_logits"}``."""
    fcfg = features.FrontendConfig()
    dcfg = det.DetectorConfig()
    eng = plan(cfg, qparams1, "lut", device)
    assert eng.int_resident, "soak must serve the packed artifact"
    telemetry.log("engine", plan=eng.describe())

    sources = sources_for(args, fcfg)
    offered_hops = sum(s["hops"] for s in sources.values())

    watch_dir = tempfile.mkdtemp(prefix="cell_soak_ckpt_")
    probe = torch.zeros((1,) + tuple(cfg.input_dim), dtype=torch.float32,
                        device=device)
    publish_after = offered_hops // 3
    B = args.slots

    with serve_common.session(args.telemetry_out) as (tracer, met):
        cell = cellmod.ServeCell(
            eng, slots=B, registry=met,
            admission=cellmod.AdmissionConfig(max_queue=args.streams),
            watch_dir=watch_dir, watch_like=qparams1, probe=probe)
        with cell:
            lanes = cell.stream_lanes(fcfg, dcfg)
            for sid in sources:
                assert cell.admission.offer(sid).admitted
            active = [None] * B
            offset = np.zeros(B, np.int64)
            done, published = [], False
            while len(done) < args.streams:
                swapped = cell.maybe_swap()
                if swapped:
                    telemetry.log("soak_swap",
                                  generation=cell.handle.generation,
                                  mid_serve_lanes=lanes.n_active)
                for lane in lanes.free_lanes():
                    sid = cell.admission.pop()
                    if sid is None:
                        break
                    lanes.join(lane)
                    active[lane], offset[lane] = sid, 0
                if not published and met.counter(
                        "cell_hops_total").value >= publish_after:
                    # [3] fresh QAT export published mid-traffic
                    qparams2, rom = publish()
                    manager.save(watch_dir, 2, qparams2)
                    published = True
                    telemetry.log("soak_publish", step=2, rom_bytes=rom)
                cs = lanes.chunk_samples
                chunk = np.zeros((B, cs), np.float32)
                ingest = np.zeros(B, np.int64)
                for i in range(B):
                    sid = active[i]
                    if sid is None:
                        continue
                    a = sources[sid]["audio"]
                    end = sources[sid]["hops"] * fcfg.hop_len
                    n = int(min(cs, end - offset[i]))
                    chunk[i, :n] = a[offset[i]:offset[i] + n]
                    offset[i] += n
                    ingest[i] = n // fcfg.hop_len
                lanes.hop(chunk, ingest=ingest)
                for i in range(B):
                    sid = active[i]
                    if sid is not None and \
                            offset[i] >= sources[sid]["hops"] * fcfg.hop_len:
                        done.append(sid)
                        lanes.evict(i)
                        active[i] = None

            # [4] the acceptance ledger
            m = cell.metrics
            failures = []
            if cell.handle.generation != 1 or m.swaps.value != 1:
                failures.append(
                    f"expected exactly one hot-swap, got generation="
                    f"{cell.handle.generation} swaps={m.swaps.value}")
            if m.swap_failures.value:
                failures.append(f"{m.swap_failures.value} swaps rejected")
            got = cell.engine.forward(probe)
            q2 = manager.restore(watch_dir, 2, qparams1)
            # bitwise vs a fresh same-flavour plan of the swapped-in
            # artifact; the dequantise-first reference bounds the
            # int-exec activation-quant envelope (hotswap gate semantics)
            same = plan(cfg, q2, "lut", device)
            if not torch.equal(got, same.forward(probe)):
                failures.append("post-swap probe logits diverge from a "
                                "fresh compile of the swapped artifact")
            ref = plan(cfg, q2, "lut", device, integer_resident=False,
                       integer_exec=False)
            err = float((got - ref.forward(probe)).abs().max())
            if err > cellmod.hotswap._INT_EXEC_PROBE_TOL:
                failures.append("post-swap probe logits outside the "
                                f"activation-quant envelope ({err:.4f})")
            if int(m.hops.value) != offered_hops or m.dropped_hops.value:
                failures.append(
                    f"hop ledger: ingested {int(m.hops.value)} != offered "
                    f"{offered_hops} (dropped={m.dropped_hops.value})")
            if len(done) != args.streams or m.evictions.value != args.streams:
                failures.append(f"{len(done)}/{args.streams} streams done, "
                                f"{m.evictions.value} evictions")
        telemetry.log("soak_done", streams=args.streams,
                      hops=int(m.hops.value), swaps=int(m.swaps.value),
                      generation=cell.handle.generation,
                      failures=len(failures))
    out = {"failures": failures, "hops": int(m.hops.value),
           "offered_hops": offered_hops, "swaps": int(m.swaps.value),
           "generation": cell.handle.generation, "probe_logits": got}
    for f in failures:
        print("FAIL:", f)
    if failures:
        return {"rc": 1, **out}
    print(f"cell soak OK: {args.streams} streams over {B} lanes, "
          f"{offered_hops} hops ingested with zero drops, one hot-swap "
          "mid-traffic with verified probe parity")
    return {"rc": 0, **out}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--hops", type=int, default=40,
                    help="mean stream length in hops")
    ap.add_argument("--train-steps", type=int, default=25)
    ap.add_argument("--qat-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    serve_common.add_telemetry_args(ap)
    add_device_arg(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    steps.no_tf32()
    cfg = registry.get("kwt-tiny").smoke
    fcfg = features.FrontendConfig()
    qparams1, publish = train(cfg, fcfg, args, device)
    return soak(cfg, qparams1, publish, args, device)["rc"]


if __name__ == "__main__":
    sys.exit(main())
