"""What the four kernel wrappers share: the device rule and the launch.

A launch costs the host a few microseconds, which at the main path's
small batches is more than the kernel's own time.  So everything that
does not change from call to call is looked up once per device and kept
in a :class:`LaunchState` (the loaded library, the ROM tables' device
addresses as plain ints), the stream is read as a raw handle without
building a ``torch.cuda.Stream``, and the device context is entered only
when the tensor is not on the current device.  The state is built at the
first launch on a device, never for a CPU tensor.

Lifetime of the buffers a launch uses: the kernels run asynchronously on
PyTorch's current stream, and the wrappers may drop their references to
temporaries (a contiguous copy, a column-scale vector) before the kernel
has run.  That is safe because PyTorch's caching allocator hands a freed
block only to later work on the same stream, which runs after the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut as lutlib
from repro_torch.kernels import build


class LaunchState:
    """Per CUDA device: the kernel library and the ROM tables' addresses.

    ``tables`` holds the table tensors themselves, so the addresses stay
    valid for the life of the process."""

    def __init__(self, index: int):
        self.index = index
        self.lib = build.load()
        self.tables = lutlib.bank_tensors(torch.device("cuda", index))
        self.exp_q24 = self.tables["exp_q24"].data_ptr()
        self.inv_q24 = self.tables["inv_q24"].data_ptr()
        self.exp_f32 = self.tables["exp_f32"].data_ptr()
        self.gelu_f32 = self.tables["gelu_f32"].data_ptr()
        # the handle of the device's current stream (PyTorch's own kernel
        # launchers read it the same way): under graph capture it is the
        # capturing stream
        self.raw_stream = torch._C._cuda_getCurrentRawStream


_STATES: dict[int, LaunchState] = {}

# When a set: every launch adds ``(entry point name, arguments)`` to it, so
# that a run can hold each launch's geometry query against its Python
# mirror afterwards (``analysis.geometry.check_launch_log``).  Off (None)
# by default; switch it on around untimed calls only, since it adds a
# hash of the arguments to every launch.
LOG: set | None = None


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the wrapper launches its kernel), False for
    a CPU tensor (the wrapper takes the plain version); any other device
    is refused."""
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise RuntimeError(f"{what}: no kernel for device {x.device}")


def state(index: int) -> LaunchState:
    """The launch state of CUDA device ``index`` (``tensor.get_device()``),
    built at its first launch."""
    st = _STATES.get(index)
    if st is None:
        st = _STATES[index] = LaunchState(index)
    return st


def launch(st: LaunchState, entry, what: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current
    stream of ``st``'s device; raise when it reports a refused launch."""
    if LOG is not None:
        LOG.add((entry.__name__, args))
    idx = st.index
    if torch.cuda.current_device() == idx:
        code = entry(*args, st.raw_stream(idx))
    else:
        with torch.cuda.device(idx):
            code = entry(*args, st.raw_stream(idx))
    if code:
        build.check(code, f"{what}, arguments {args}")

