"""whisper-large-v3 [audio]: 32L d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866 — enc-dec, conv frontend (STUB).  [arXiv:2212.04356]

Per the assignment the conv frontend is stubbed: input_specs() provides
precomputed frame embeddings [B, 1500, 1280].  GELU MLPs (the paper's
LUT-GELU applies directly), LayerNorm, biases, sinusoidal positions.
long_500k is skipped (full attention).
"""
from repro_torch.configs.base import ArchEntry, LM_SHAPES, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, enc_seq=1500,
    d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    activation="gelu", gated_mlp=False, bias=True, norm="layernorm",
    use_rope=False, tie_embeddings=True,
)

SKIPS = {"long_500k": "full attention (quadratic); assigned only to "
                      "SSM/hybrid/linear-attn archs"}


def smoke_config():
    return CONFIG.with_(n_layers=2, n_enc_layers=2, enc_seq=16, d_model=64,
                        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                        vocab_size=256, dtype="float32", remat=False)


ENTRY = ArchEntry(CONFIG, LM_SHAPES, SKIPS, smoke_config())
