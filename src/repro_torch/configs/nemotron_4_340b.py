"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP.  [arXiv:2402.16819]

Largest assigned arch (~340B params).  Its layers run at full width on
one card at a cut depth (``chip_smoke.py`` phase ``lm_nemotron``: 2 of
96 layers, the flash-LUT attention at head_dim 192 on
``csrc/lut_attention_wide.cu``); the full depth needs sharding across
many cards (the port's mesh runs on one card, or on gloo CPU ranks).
"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000,
    activation="sqrelu", gated_mlp=False, norm="layernorm",
)

SKIPS = {"long_500k": "full attention (quadratic); assigned only to "
                      "SSM/hybrid/linear-attn archs"}


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=256, vocab_size=256,
                        dtype="float32", remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
