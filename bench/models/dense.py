"""The dense decoder-only LM family (internlm2, arXiv:2403.17297): an
embedding, ``n_layers`` pre-norm blocks of causal GQA attention and a
gated MLP, a final norm and an untied head; ``vocab_size`` padded to a
multiple of 128 in the program's tree.

A call's work (``work()`` of a traffic kind) is ``batch`` sequences of
``seq_len`` tokens, every position attending to itself and those before.
"""


def padded_vocab(model: dict) -> int:
    return -(-model["vocab_size"] // 128) * 128


def layout(model: dict) -> dict:
    """Leaf shapes of the program's tree; a leaf is ``(shape, kind)``
    (``bench/core/weights.py``)."""
    n, d = model["n_layers"], model["d_model"]
    h, kv, dh, f = (model["n_heads"], model["n_kv_heads"], model["head_dim"],
                    model["d_ff"])
    v = padded_vocab(model)
    return {"embed": ((v, d), "matrix"),
            "blocks": {"ln1": {"scale": ((n, d), "norm")},
                       "ln2": {"scale": ((n, d), "norm")},
                       "attn": {"wq": ((n, d, h * dh), "stacked"),
                                "wk": ((n, d, kv * dh), "stacked"),
                                "wv": ((n, d, kv * dh), "stacked"),
                                "wo": ((n, h * dh, d), "stacked")},
                       "mlp": {"w_gate": ((n, d, f), "stacked"),
                               "w_up": ((n, d, f), "stacked"),
                               "w_down": ((n, f, d), "stacked")}},
            "ln_f": {"scale": ((d,), "norm")},
            "lm_head": ((d, v), "matrix")}


def flops(model: dict, work: dict) -> float:
    """Model FLOPs of one causal forward, head included: 2 per
    multiply-add of every projection, score and P.V product, causal pairs
    only; no norms."""
    d, dh, h, kv, f = (model["d_model"], model["head_dim"], model["n_heads"],
                       model["n_kv_heads"], model["d_ff"])
    batch, seq = work["batch"], work["seq_len"]
    per_tok = 2 * d * (h * dh + 2 * kv * dh) + 2 * h * dh * d + 6 * d * f
    pairs = seq * (seq + 1) // 2
    attn = 2 * 2 * h * dh * pairs
    head = 2 * d * model["vocab_size"]
    return batch * (model["n_layers"] * (seq * per_tok + attn) + seq * head)


def kernel_work(config: dict, work: dict) -> dict:
    """The shapes of one call's work for each kernel family that the
    configuration's plan gives it (``bench/kernels/<family>.py``): the
    head integer-executed (the plan runs the blocks as a float32 view of
    their cast), the causal attention of every layer."""
    model = config["model"]
    b, s = work["batch"], work["seq_len"]
    xb = 2 if model["dtype"] == "bfloat16" else 4
    return {"int8_matmul": [(b * s, model["d_model"], padded_vocab(model),
                             xb, config["quant"]["per_channel"])],
            "lut_attention": [(b, model["n_heads"], model["n_kv_heads"], s,
                               s, model["head_dim"], True)]
            * model["n_layers"]}
