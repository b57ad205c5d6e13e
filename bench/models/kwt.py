"""The KWT family (Berg et al., arXiv:2104.00769; KWT-Tiny,
arXiv:2407.16026): a patch embedding of each MFCC frame, a class token
and learned positions, ``n_layers`` post-norm blocks of attention and a
GELU MLP, a linear head on the class token.

A call's work (``work()`` of a traffic kind) is ``batch`` windows, of
which ``new_frames`` frames each are embedded anew (every frame of a
window offline, a step's hops in a stream; all ``T`` where the key is
absent); the encoder runs over the class token and all ``T`` frames.
"""


def layout(model: dict) -> dict:
    """Leaf shapes of the program's tree; a leaf is ``(shape, kind)``
    (``bench/core/weights.py``)."""
    d, h, kv, dh, f = (model["d_model"], model["n_heads"],
                       model["n_kv_heads"], model["head_dim"], model["d_ff"])
    feat, t = model["input_dim"]
    vec = lambda n: ((n,), "vector")                           # noqa: E731
    norm = lambda: {"scale": ((d,), "norm"), "bias": vec(d)}   # noqa: E731
    block = {"ln1": norm(), "ln2": norm(),
             "attn": {"wq": ((d, h * dh), "matrix"),
                      "wk": ((d, kv * dh), "matrix"),
                      "wv": ((d, kv * dh), "matrix"),
                      "wo": ((h * dh, d), "matrix"),
                      "bq": vec(h * dh), "bk": vec(kv * dh),
                      "bv": vec(kv * dh), "bo": vec(d)},
             "mlp": {"w1": ((d, f), "matrix"), "w2": ((f, d), "matrix"),
                     "b1": vec(f), "b2": vec(d)}}
    return {"proj_w": ((feat, d), "matrix"), "proj_b": vec(d),
            "cls": vec(d), "pos": ((t + 1, d), "matrix"),
            "blocks": [block] * model["n_layers"],
            "head_w": ((d, model["n_classes"]), "matrix"),
            "head_b": vec(model["n_classes"])}


def _sizes(model: dict, work: dict):
    feat, t = model["input_dim"]
    return work["batch"], work.get("new_frames", t), feat, t + 1


def flops(model: dict, work: dict) -> float:
    """Model FLOPs of one call: 2 per multiply-add of the embedding, every
    projection, score and P.V product, and the head; no norms."""
    b, new, feat, s = _sizes(model, work)
    d, dh, h, f = model["d_model"], model["head_dim"], model["n_heads"], \
        model["d_ff"]
    proj = 2 * d * (h * dh + 2 * model["n_kv_heads"] * dh) + 2 * h * dh * d
    layer = s * (proj + 4 * d * f) + 2 * 2 * h * s * s * dh
    return b * (2 * new * feat * d + model["n_layers"] * layer
                + 2 * d * model["n_classes"])


def kernel_work(config: dict, work: dict) -> dict:
    """The shapes of one call's work for each kernel family that the
    configuration's plan gives it (``bench/kernels/<family>.py``): every
    linear integer-executed, the LUT softmax on every attention row, the
    LUT GELU on every MLP element."""
    model, quant = config["model"], config["quant"]
    b, new, feat, s = _sizes(model, work)
    d, f = model["d_model"], model["d_ff"]
    hq = model["n_heads"] * model["head_dim"]
    hkv = model["n_kv_heads"] * model["head_dim"]
    xb = 2 if model["dtype"] == "bfloat16" else 4
    pc = quant["per_channel"]
    m = b * s
    layer = [(m, d, hq), (m, d, hkv), (m, d, hkv), (m, hq, d), (m, d, f),
             (m, f, d)]
    linears = [(b * new, feat, d)] + layer * model["n_layers"] \
        + [(b, d, model["n_classes"])]
    out = {"int8_matmul": [(mm, k, n, xb, pc) for mm, k, n in linears],
           "lut_softmax": [(b * model["n_heads"] * s, s)]
           * model["n_layers"]}
    if model["activation"] == "gelu":
        out["lut_gelu"] = [(m * f,)] * model["n_layers"]
    return out
