"""KWT-1 (Table I/III): 12 layers, DIM 64, 1 head, DIM_HEAD 64,
MLP_DIM 256, MFCC [40,98], SEQLEN 99, 35 classes, ~607k params."""
from repro_torch.configs.base import ArchEntry, ModelConfig

CONFIG = ModelConfig(
    name="kwt-1", family="kwt",
    n_layers=12, d_model=64, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=256, vocab_size=0, n_classes=35,
    input_dim=(40, 98), patch_dim=(40, 1),
    activation="gelu", gated_mlp=False, bias=True, norm="layernorm",
    post_norm=True, use_rope=False, dtype="float32",
    remat=False, scan_layers=False,
)


def smoke_config():
    return CONFIG.with_(n_layers=2)


ENTRY = ArchEntry(CONFIG, (), {}, smoke_config())
