"""``aten_ops.<cell group>``: the ATen ops one call dispatches (one
forward, or one hop with its refill), counted by a ``TorchDispatchMode``;
a kernel launched through ``ctypes`` is not one."""


def read(name, run):
    return None if run.aten_ops is None else float(run.aten_ops)
