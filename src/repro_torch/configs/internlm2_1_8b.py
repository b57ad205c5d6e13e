"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA.  [arXiv:2403.17297]"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544,
    activation="silu", gated_mlp=True, norm="rmsnorm",
)

SKIPS = {"long_500k": "full attention (quadratic); assigned only to "
                      "SSM/hybrid/linear-attn archs"}


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=256,
                        dtype="float32", remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
