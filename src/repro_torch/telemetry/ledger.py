"""The comm-volume ledger: the port of the JAX package's
``telemetry/ledger.py``. The elastic restore itemizes the bytes a reshard
moves in one (``elastic.apply``); ``train_step_ledger`` charges one
hybrid-parallel train step's collectives analytically, from the head and
the ring's size.

Model of one step (``train.hybrid``), P members on the ring, R global
rows a step (features [R, D] f32, labels [R] i32), ``n_micro``
micro-batches; bytes are the collective's output shape, by kind:

  all-gather       features R*D*4 + labels R*4 bytes.
  all-reduce (CE)  the distributed softmax's completion moves [b]-sized
                   terms a micro-batch: the ``ref`` backend's 5 forward
                   (m, z, corr, vmax, pred_here), the kernel path's 4
                   (vmax reused), plus 2 backward ones (the transpose of
                   the z and corr ``psum``s): 7 ref / 6 kernel. The knn
                   head adds the label-recall psum [b] and a scalar
                   active-fraction pmean a micro-batch.
  reduce-scatter   the feature all-gather's backward, R*D*4/P: only when
                   the trunk has trainable params.
  all-reduce (fe)  the dense gradient exchange: 4 bytes a trunk param.

``CommLedger.compare`` diffs the ledger against a measured count by kind
and bytes; the port measures it at the ``dist`` wrappers
(``dist.count_collectives``), where the JAX package parses the compiled
HLO.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "reshard")

# heads whose per-step collectives the ledger models exactly
LEDGER_HEADS = ("full", "knn")


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


def train_step_ledger(*, n_dev: int, rows: int, feat_dim: int,
                      head: str = "full", backend: str = "ref",
                      n_micro: int = 1, fe_param_count: int = 0,
                      dtype_bytes: int = 4,
                      label_bytes: int = 4) -> CommLedger:
    """The analytic ledger of one hybrid-parallel train step: ``rows`` the
    GLOBAL rows a step, ``fe_param_count`` the trunk's trainable params (0
    for the feats trunk: no backward or exchange collectives). ``backend``
    is ``"ref"`` or the kernel path (the JAX package's ``"pallas"``, the
    port's ``"kernel"``)."""
    if head not in LEDGER_HEADS:
        raise ValueError(
            f"ledger models heads {LEDGER_HEADS}, got {head!r} — extend "
            f"the model before charging it")
    if rows % n_micro:
        raise ValueError(f"rows={rows} not divisible by n_micro={n_micro}")
    led = CommLedger()
    led.add("all-gather", "features[R,D]", rows * feat_dim * dtype_bytes,
            count=n_micro)
    led.add("all-gather", "labels[R]", rows * label_bytes, count=n_micro)
    ce_terms = 7 if backend == "ref" else 6
    led.add("all-reduce", f"softmax_ce({backend})",
            ce_terms * rows * dtype_bytes, count=ce_terms * n_micro)
    if head == "knn":
        led.add("all-reduce", "knn_label_recall", rows * dtype_bytes,
                count=n_micro)
        led.add("all-reduce", "knn_active_frac", dtype_bytes * n_micro,
                count=n_micro)
    if fe_param_count > 0:
        led.add("reduce-scatter", "d_features",
                rows * feat_dim * dtype_bytes // n_dev, count=n_micro)
        led.add("all-reduce", "fe_grad_exchange",
                fe_param_count * dtype_bytes)
    return led
