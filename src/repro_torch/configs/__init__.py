from repro_torch.configs import base, registry  # noqa: F401
from repro_torch.configs.base import (ArchEntry, ModelConfig, QuantConfig,  # noqa: F401
                                      ShapeSpec)
