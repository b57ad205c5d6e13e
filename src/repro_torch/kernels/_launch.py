"""What the three kernel wrappers share: the device rule and the stream.

Lifetime of the buffers a launch uses: the kernels run asynchronously on
PyTorch's current stream, and the wrappers may drop their references to
temporaries (a contiguous copy, a column-scale vector) before the kernel
has run.  That is safe because PyTorch's caching allocator hands a freed
block only to later work on the same stream, which runs after the kernel.
"""

from __future__ import annotations

import torch


def require_cuda(x: torch.Tensor, what: str) -> None:
    """A wrapper launches for a CUDA tensor and takes the plain version
    for a CPU tensor; any other device is refused."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")


def stream_of(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as the integer handle
    the C entry points take."""
    return torch.cuda.current_stream(x.device).cuda_stream
