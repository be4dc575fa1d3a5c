"""The comm-volume ledger: the port of ``Collective`` and ``CommLedger``
from the JAX package's ``telemetry/ledger.py``. The elastic restore
itemizes the bytes a reshard moves in one (``elastic.apply``). The
per-step training ledger (``train_step_ledger``) waits for ROADMAP.md
A.8."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "reshard")


@dataclass
class Collective:
    """One charged collective: ``bytes`` is its total (output-shape
    bytes), ``count`` the number of launches."""
    kind: str
    label: str
    bytes: float
    count: int = 1


class CommLedger:
    """An itemized comm bill: the collectives of a step, or the bytes a
    reshard moves. ``per_kind`` gives the per-kind totals."""

    def __init__(self, entries: Optional[list] = None):
        self.entries: list[Collective] = list(entries or [])

    def add(self, kind: str, label: str, nbytes: float,
            count: int = 1) -> "CommLedger":
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}; "
                             f"expected one of {COLLECTIVE_KINDS}")
        self.entries.append(Collective(kind, label, float(nbytes), count))
        return self

    def per_kind(self) -> dict:
        """{kind: {"bytes", "count"}} + "total_bytes"."""
        out: dict = {}
        for e in self.entries:
            slot = out.setdefault(e.kind, {"bytes": 0.0, "count": 0})
            slot["bytes"] += e.bytes
            slot["count"] += e.count
        out["total_bytes"] = sum(e.bytes for e in self.entries)
        return out

    def total_bytes(self) -> float:
        return sum(e.bytes for e in self.entries)

    def compare(self, measured: dict, *, rtol: float = 0.05) -> list:
        """Diff this ledger against a measured ``{kind: {"bytes"}}`` dict.
        Returns a line for every kind whose bytes disagree by more than
        ``rtol`` relative: empty means the two agree."""
        mine = self.per_kind()
        problems = []
        kinds = (set(mine) | set(measured)) - {"total_bytes"}
        for kind in sorted(kinds):
            a = float(mine.get(kind, {}).get("bytes", 0.0))
            b = float(measured.get(kind, {}).get("bytes", 0.0))
            if a == 0.0 and b == 0.0:
                continue
            rel = abs(a - b) / max(a, b)
            if rel > rtol:
                problems.append(
                    f"{kind}: ledger {a:.0f} B vs measured {b:.0f} B "
                    f"({rel:.1%} > rtol {rtol:.1%})")
        return problems
