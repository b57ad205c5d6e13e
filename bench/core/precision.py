"""The precision of float32 products, as the process's matmul settings
show it.  A configuration that states float32 products with TF32 off
(``"tf32": false``) is held to it: the settings are read after set-up and
after the window, and a run that finds TF32 allowed reads the compared
number ``tf32`` 1 against its limit 0.  The reference runs with TF32 off,
whatever the program left set."""

from __future__ import annotations

import warnings

import torch


def tf32_allowed() -> bool:
    """Whether a float32 matmul may take TF32 (any of torch's switches)."""
    m = torch.backends.cuda.matmul
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (bool(m.allow_tf32)
                or torch.get_float32_matmul_precision() != "highest"
                or getattr(m, "fp32_precision", "none") == "tf32")


def allow_tf32(on: bool) -> None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.set_float32_matmul_precision("high" if on else "highest")
        torch.backends.cuda.matmul.allow_tf32 = on
