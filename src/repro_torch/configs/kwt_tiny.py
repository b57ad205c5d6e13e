"""KWT-Tiny (the paper's model, Table III): 1 layer, DIM 12, 1 head,
DIM_HEAD 8, MLP_DIM 24, MFCC [16,26], SEQLEN 27, 2 classes, ~1.6k params."""
from repro_torch.configs.base import ArchEntry, ModelConfig, QuantConfig

CONFIG = ModelConfig(
    name="kwt-tiny", family="kwt",
    n_layers=1, d_model=12, n_heads=1, n_kv_heads=1, head_dim=8,
    d_ff=24, vocab_size=0, n_classes=2,
    input_dim=(16, 26), patch_dim=(16, 1),
    activation="gelu", gated_mlp=False, bias=True, norm="layernorm",
    post_norm=True, use_rope=False, dtype="float32",
    remat=False, scan_layers=False,
    quant=QuantConfig(),            # Table V best: weights 2^6, inputs 2^5
)


def smoke_config():
    return CONFIG


ENTRY = ArchEntry(CONFIG, (), {}, smoke_config())
