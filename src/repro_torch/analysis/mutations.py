"""Seeded violations that prove the checker checks (mutation testing).

Each context manager monkeypatches one invariant the pass pipeline
guards, so tests can assert the corresponding pass flips to FAIL —
without the mutations, a regression in the checker itself (e.g. a taint
walk that silently stops at a kernel charge) would keep reporting green
forever.

    float_leak   - residency: dequantise integer weights through a path
                   with no sanctioned frame (bypasses resident_values)
    unsat_shift  - ranges: restore the wrapping left shift in
                   fixed_shift_mul
    big_lut      - budget: inflate the reported LUT bank past 64 kB

The patched functions are looked up through their modules by every
caller (``quant.resident_values`` by ``quant.qt_einsum`` and
``models.layers.asfloat``; ``fixedpoint.fixed_shift_mul`` by the ranges
contract), so a patch reaches every program the passes run.

Usage::

    with mutations.apply("float_leak"):
        report = analysis.check_engine(engine)
    assert not report.ok
"""

from __future__ import annotations

import contextlib

import torch

MUTATIONS = ("float_leak", "unsat_shift", "big_lut")


@contextlib.contextmanager
def float_leak():
    """Dequantise stored-integer weights inline, with no sanctioned frame:
    the residency pass must flag the tainted int->float cast."""
    from repro_torch.core import quant

    orig = quant.resident_values

    def _leaky_values(w):
        out = w.int_values().to(torch.float32) * (2.0 ** (-w.exponent))
        if w.axis_exponents is not None:
            out = out * torch.exp2(-w.axis_exponents.to(torch.float32))
        return out

    quant.resident_values = _leaky_values
    try:
        yield
    finally:
        quant.resident_values = orig


@contextlib.contextmanager
def unsat_shift():
    """Restore the wrapping left shift: the range pass must flag the
    unguarded int32 overflow."""
    from repro_torch.core import fixedpoint as fxp

    orig = fxp.fixed_shift_mul

    def _wrapping(a, shift):
        if shift >= 0:
            return a.to(torch.int32) << shift
        return a.to(torch.int32) >> (-shift)

    fxp.fixed_shift_mul = _wrapping
    try:
        yield
    finally:
        fxp.fixed_shift_mul = orig


@contextlib.contextmanager
def big_lut():
    """Report a 70 kB LUT bank: the budget pass must fail the 64 kB gate."""
    from repro_torch.runtime.engine import Engine

    orig = Engine.lut_bytes
    Engine.lut_bytes = property(lambda self: 70_000)
    try:
        yield
    finally:
        Engine.lut_bytes = orig


@contextlib.contextmanager
def apply(name: str | None):
    """Apply one mutation by name (None / "none": no-op)."""
    if name in (None, "none"):
        yield
        return
    if name not in MUTATIONS:
        raise ValueError(f"unknown mutation {name!r}; pick from {MUTATIONS}")
    with {"float_leak": float_leak, "unsat_shift": unsat_shift,
          "big_lut": big_lut}[name]():
        yield
