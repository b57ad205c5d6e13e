"""Config system of the port: model configs, quantisation flags, registry.

A field-for-field copy of the reference's ``configs/base.py`` dataclasses
(the port keeps its own copy so that it imports nothing of the JAX
package).  Fields that only steer XLA / the TPU mesh are kept for
field-set parity and are never read here; ``kernel_interpret`` in
particular has no meaning on a CUDA card (a CUDA kernel has no interpret
mode).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """The paper's technique as a first-class serving feature (§IV, §VI)."""

    enabled: bool = True
    weight_exponent: int = 6      # Table V best row: weights 2^6
    input_exponent: int = 5       # Table V best row: inputs 2^5
    bits: int = 8                 # stored weight width; <=4 nibble-packs
    residual_bits: int = 16       # paper: INT16 intermediates
    softmax_mode: str = "lut"     # "exact" | "lut" | "lut_fixed"
    act_mode: str = "lut"         # LUT GELU / SiLU
    quantize_kv_cache: bool = False   # int8 KV cache
    per_channel: Optional[bool] = None  # None: registry default (LM-scale
    #                                     families per-channel, kwt scalar)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | rwkv | hybrid | encdec | kwt
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # --- block flavour ---
    activation: str = "silu"
    gated_mlp: bool = True
    qkv_bias: bool = False
    bias: bool = False            # biases on all linears (KWT)
    qk_norm: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    post_norm: bool = False       # KWT/ViT-as-per-paper uses post-norm
    use_rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- SSM / RWKV / hybrid ---
    ssm_state: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    sliding_window: int = 0       # 0 -> full attention
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_seq: int = 0
    # --- KWT (the paper's own model) ---
    input_dim: tuple = ()
    patch_dim: tuple = ()
    n_classes: int = 0
    # --- numerics / the paper's technique ---
    dtype: str = "bfloat16"
    # softmax_mode / act_approx are pinned by repro_torch.runtime backends
    # at plan time (runtime.compile_model); no call site outside
    # repro_torch/runtime should mutate them directly.
    softmax_mode: str = "exact"   # exact | lut | lut_fixed | cuda
    act_approx: str = "exact"     # exact | lut | cuda
    kernel_interpret: bool = True  # field-set parity only; never read
    int_exec: bool = False        # integer-executing plan; pinned by
    #                               runtime.compile_model, never set by hand
    quant: Optional[QuantConfig] = None
    # --- compile / distribution knobs (remat: layers.remat, in training;
    #     the rest field-set parity, unread) ---
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "xla"        # xla: plain einsum attention; flash_lut:
    #                               the flash-LUT attention (kernels.ops)
    seq_shard_activations: bool = False
    scores_dtype: str = "float32"
    pure_fsdp: bool = False
    tp_only: bool = False
    rwkv_head_pad: bool = False
    rwkv_fused_proj: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128; the head masks the pad
        logits to -1e30."""
        return -(-self.vocab_size // 128) * 128

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("rwkv", "hybrid") or self.sliding_window > 0

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: ModelConfig
    shapes: tuple
    skips: dict                   # shape name -> reason (documented skips)
    smoke: ModelConfig
