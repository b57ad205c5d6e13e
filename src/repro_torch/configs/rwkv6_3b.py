"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— RWKV-6 "Finch", data-dependent decay.  [arXiv:2404.05892]

No softmax anywhere in time-mix: the paper's LUT-softmax is inapplicable
(DESIGN.md §Arch-applicability); sigmoid/ReLU^2 use the bounded-domain LUT
method and int8 PTQ applies to all projections.  All shapes runnable
(sub-quadratic; O(1) decode state).
"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    gated_mlp=False, norm="layernorm", use_rope=False,
)

SKIPS = {}


def smoke_config():
    return CONFIG.with_(n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                        head_dim=64, d_ff=128, vocab_size=256,
                        dtype="float32", remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
