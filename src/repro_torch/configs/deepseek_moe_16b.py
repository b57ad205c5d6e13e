"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, 2 shared + 64 routed experts top-6, fine-grained.
[arXiv:2401.06066]
"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, expert_d_ff=1408,
    activation="silu", gated_mlp=True, norm="rmsnorm",
)

SKIPS = {"long_500k": "full attention (quadratic); assigned only to "
                      "SSM/hybrid/linear-attn archs"}


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                        head_dim=16, d_ff=32, expert_d_ff=32, n_experts=8,
                        n_shared_experts=2, top_k=2, vocab_size=256,
                        dtype="float32", remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
