"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064,
    activation="silu", gated_mlp=True, norm="rmsnorm", qkv_bias=True,
)

SKIPS = {"long_500k": "full attention (quadratic); assigned only to "
                      "SSM/hybrid/linear-attn archs"}


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=256,
                        dtype="float32", remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
