"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn+mamba heads.  [arXiv:2411.13676]

The attention half uses a 2048 sliding window (Hymba's local-attention
configuration), making long_500k runnable: O(1) mamba state + O(W) ring
KV cache.
"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, conv_width=4, dt_rank=100, sliding_window=2048,
    activation="silu", gated_mlp=True, norm="rmsnorm",
)

SKIPS = {}


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, d_ff=128, ssm_state=8, dt_rank=8,
                        sliding_window=8, vocab_size=256, dtype="float32",
                        remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
