"""Twins of the reference's ``examples/*.py``, one module each.

Run one as ``python -m repro_torch.examples.<name> [--device cpu]``.
Every twin keeps the reference's flags and defaults and prints its lines
in the same words and number formats; it adds ``--device`` (without it
the twin runs on the card and raises where there is none) and offers the
backend ``cuda`` where the reference offers ``pallas``.  Each keeps the
part it trains apart from the part it evaluates, serves or reports, so
that the parity tests can feed the reporting part the reference's
weights.
"""
