"""Finding / PassResult / Report: the analysis subsystem's output types.

Every pass (residency, ranges, budget, geometry) emits one ``PassResult``
holding a list of ``Finding``s.  Severity semantics:

  ``violation``   - the pass refutes an invariant; the check FAILS.
  ``whitelisted`` - a known/sanctioned occurrence of the flagged pattern
                    (e.g. the lut backend's unpack-stage float casts, the
                    reciprocal's mantissa-normalisation shift), reported
                    with its justification but not fatal.
  ``assumption``  - a declared domain fact the pass relied on (e.g. the
                    dominant-lane row-sum >= 1 bound); reported so the
                    proof's trust base is explicit.
  ``warning``     - suspicious but not gating for this plan.
  ``info``        - measurement lines (budget tables, kernel geometry).
"""

from __future__ import annotations

import dataclasses

SEVERITIES = ("violation", "whitelisted", "assumption", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    severity: str                 # one of SEVERITIES
    kind: str                     # e.g. "float-leak", "int32-overflow"
    message: str
    site: str = ""                # "function (file.py:line)" when known

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    def render(self) -> str:
        where = f"  @ {self.site}" if self.site else ""
        return f"[{self.severity}] {self.kind}: {self.message}{where}"


@dataclasses.dataclass
class PassResult:
    name: str                     # residency | ranges | budget | geometry
    findings: list
    metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(f.severity == "violation" for f in self.findings)

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def render(self) -> str:
        head = f"-- {self.name}: {'PASS' if self.ok else 'FAIL'}"
        if self.metrics:
            head += "  (" + ", ".join(
                f"{k}={v}" for k, v in self.metrics.items()) + ")"
        return "\n".join([head] + ["   " + f.render() for f in self.findings])


@dataclasses.dataclass
class Report:
    """All pass results for one Engine plan."""

    engine_desc: str
    results: list                 # [PassResult]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def result(self, name: str) -> PassResult:
        for r in self.results:
            if r.name == name:
                return r
        raise KeyError(name)

    def verdict(self) -> str:
        """One-line summary (what Engine.describe appends)."""
        if self.ok:
            parts = []
            res = {r.name: r for r in self.results}
            if "residency" in res:
                parts.append(
                    f"leaks {res['residency'].metrics.get('float_leak_count', 0)}"
                    " whitelisted")
            if "budget" in res:
                m = res["budget"].metrics
                tot, cap = m.get("total_bytes"), m.get("budget_bytes")
                parts.append(f"ram {tot}/{cap} B" if cap else f"ram {tot} B")
            return "analysis: ok (" + ", ".join(parts) + ")"
        bad = ",".join(r.name for r in self.results if not r.ok)
        return f"analysis: FAIL({bad})"

    def render(self) -> str:
        return "\n".join([self.engine_desc] +
                         [r.render() for r in self.results] +
                         [self.verdict()])
