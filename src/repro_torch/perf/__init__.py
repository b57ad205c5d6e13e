"""repro_torch.perf — measurement of the port.

Only the ledger is ported so far (:mod:`repro_torch.perf.ledger`: the
JSONL bench ledger, its regression gate and ``provenance()``, which the
flight recorder stamps on its dumps).  The cost model, the rooflines and
the benchmark twins are ROADMAP queue A item 2.
"""

from repro_torch.perf.ledger import (Verdict, append, entry, git_commit,
                                     provenance, read, regress)

__all__ = ["Verdict", "append", "entry", "git_commit", "provenance", "read",
           "regress"]
