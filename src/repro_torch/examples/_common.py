"""What the example twins share: the ``--device`` flag and planning."""

from __future__ import annotations

from repro_torch import runtime


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one); 'cpu' runs a cuda plan through its "
                         "kernels' plain versions")


def plan(cfg, params, backend: str, device, **kw):
    """``runtime.compile_model`` on ``device``; on the CPU a ``cuda`` plan
    takes its kernels' plain versions."""
    return runtime.compile_model(cfg, params, backend=backend, device=device,
                                 plain_kernels=device.type == "cpu", **kw)
