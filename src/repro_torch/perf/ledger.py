"""Append-only bench ledger + rolling-baseline regression gate.

A bench ledger is a JSONL trajectory: every sweep row lands as one JSON
line with full provenance (git commit, torch and CUDA versions, the card
and its power limit, roofline calibration id), so "did this change make
`cuda` slower" is a query, not archaeology.  The port's benchmark twins
(ROADMAP queue A item 2) will write ``BENCH_torch_history.jsonl``; until
then :func:`provenance` stamps the flight recorder's dumps
(``telemetry.flight``).

Entry schema (one line each, append-only, never rewritten)::

    {"arch": .., "backend": .., "batch": ..,        # the key
     "latency": .., "latency_unit": "mean_us" | "ms_per_hop"
                                    | "ms_per_token" | "ratio_mean_us",
     "rom_bytes": ..,                               # packed image bytes
     "extra": {...},                                # free-form row tail
     "provenance": {git_commit, torch_version, cuda_version, device,
                    power_limit, timestamp, calibration}}

The gate compares the NEWEST entry per (arch, backend, batch,
latency_unit) key against the **median of the previous ``window``
entries** for that key (median, not last: one noisy CI run must not
move the baseline) and fails on >``tol`` latency growth or ANY
rom_bytes growth — ROM is deterministic, so any increase is a real
packaging regression, while latency gets slack for host noise.  Keys
with no prior history pass (first entry seeds the baseline).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
from typing import Optional

HISTORY_PATH = "BENCH_torch_history.jsonl"
DEFAULT_TOL = 0.15
DEFAULT_WINDOW = 5


# -- provenance -------------------------------------------------------------

def git_commit(cwd: Optional[str] = None) -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "unknown"


def provenance(calibration=None) -> dict:
    """Identity block stamped on ledger entries AND bench JSON headers
    (same dict in both places, so artifacts and history cross-reference).

    Names the PyTorch and CUDA versions, the device the port runs on by
    default (the card, or the CPU where there is none) and the card's
    power limit: a card set below its maximum runs slower under load, so
    no time is comparable without it."""
    import torch
    if torch.cuda.is_available():
        device, power = f"cuda:{torch.cuda.get_device_name(0)}", _power_limit()
    else:
        device, power = "cpu", None
    return {
        "git_commit": git_commit(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": device,
        "power_limit": power,
        "host_cpus": os.cpu_count(),
        "timestamp": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "calibration": getattr(calibration, "id", calibration),
    }


# -- entries ----------------------------------------------------------------

def entry(arch: str, backend: str, batch: int, latency: float,
          latency_unit: str, rom_bytes: int = 0, extra: Optional[dict] = None,
          prov: Optional[dict] = None) -> dict:
    return {"arch": arch, "backend": backend, "batch": int(batch),
            "latency": float(latency), "latency_unit": latency_unit,
            "rom_bytes": int(rom_bytes), "extra": extra or {},
            "provenance": prov or provenance()}


def append(path: str, entries) -> int:
    """Append entries as JSONL; returns how many were written."""
    if isinstance(entries, dict):
        entries = [entries]
    entries = list(entries)
    with open(path, "a") as f:
        for e in entries:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(entries)


def read(path: str) -> list:
    """All ledger entries in append order (missing file → empty history)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _key(e: dict) -> tuple:
    return (e.get("arch"), e.get("backend"), e.get("batch"),
            e.get("latency_unit"))


def _median(xs: list) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


# -- the gate ---------------------------------------------------------------

@dataclasses.dataclass
class Verdict:
    """Outcome of the regression gate over one ledger."""

    checked: int
    skipped: int                       # keys with no prior baseline
    failures: list                     # human-readable failure strings

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        head = (f"regress: {self.checked} keys checked, "
                f"{self.skipped} unseeded, {len(self.failures)} failed")
        return "\n".join([head] + [f"  FAIL {f}" for f in self.failures])


def regress(path: str = HISTORY_PATH, tol: float = DEFAULT_TOL,
            window: int = DEFAULT_WINDOW) -> Verdict:
    """Gate the newest entry of every key against its rolling baseline."""
    by_key: dict = {}
    for e in read(path):
        by_key.setdefault(_key(e), []).append(e)

    checked = skipped = 0
    failures = []
    for key, hist in sorted(by_key.items(), key=lambda kv: str(kv[0])):
        newest, prior = hist[-1], hist[:-1][-window:]
        if not prior:
            skipped += 1
            continue
        checked += 1
        name = "/".join(str(k) for k in key)
        base_lat = _median([p["latency"] for p in prior])
        if base_lat > 0 and newest["latency"] > (1.0 + tol) * base_lat:
            failures.append(
                f"{name}: latency {newest['latency']:.4g} "
                f"{newest['latency_unit']} vs baseline {base_lat:.4g} "
                f"(+{100 * (newest['latency'] / base_lat - 1):.1f}% "
                f"> {100 * tol:.0f}% tol) "
                f"[commit {newest['provenance'].get('git_commit')}]")
        base_rom = _median([p.get("rom_bytes", 0) for p in prior])
        if newest.get("rom_bytes", 0) > base_rom:
            failures.append(
                f"{name}: rom_bytes {newest['rom_bytes']} vs baseline "
                f"{base_rom:.0f} (any growth fails — packing is "
                f"deterministic) "
                f"[commit {newest['provenance'].get('git_commit')}]")
    return Verdict(checked=checked, skipped=skipped, failures=failures)
