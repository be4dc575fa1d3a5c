"""Kill-and-recover harness: inject a fault, restore, prove equivalence.
The port of the JAX package's ``resilience/harness.py``.

A run killed at step ``k`` and resumed by a FRESH experiment from its
latest full-state checkpoint must be equivalent to a run that was never
interrupted:

  * ``"bitwise"``: every leaf of the final snapshot (FE params, head params
    and aux, optimizer moments, DGC's u and v, the cursor) is byte-equal,
    and the loss rows match exactly. It holds where the path is run-to-run
    deterministic: the data stream, the FCCS schedule and the per-step
    sampling are functions of the saved cursor. A caller claims it only
    for a path whose two uninterrupted runs are bit-equal.
  * ``"trajectory"``: the resumed losses match the reference's within
    ``loss_tol`` (a path with nondeterministic operations, such as a
    convolution backward that picks a nondeterministic algorithm).

Both systems go through it: the paper system's experiments (their
``trainer``) and the zoo's (``ZooExperiment``: its own ``_snapshot``,
cursor, history and telemetry). ``kill_and_recover`` runs the three legs
(reference, victim, resume) in this process (on a ring, every member runs it; member 0 writes the
checkpoint). The victim is dropped, and the card's cache emptied, before
the resumed experiment is built, so no more than two experiments hold the
card's memory at once. ``tree_compare`` compares tensors where they lie,
on the card, without copying the state to the host.
``elastic_kill_and_recover`` runs each leg on its own ``dist.spawn_ring``
ring of CPU processes: the victim on the source ring, the reference and
the resumed run on the destination ring.
"""
from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.core.sparsify import flatten
from repro_torch.resilience.faults import FaultPlan, SimulatedFault, fault_hook

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
_DIFF_CHUNK = 1 << 24


# ---------------------------------------------------------------------------
# tree comparison
# ---------------------------------------------------------------------------


def _tensor(leaf, device=None) -> torch.Tensor:
    t = (leaf if torch.is_tensor(leaf)       # (a read-only array: a copy)
         else torch.from_numpy(np.require(leaf, requirements=("C", "W"))))
    return t.detach().to(device) if device is not None else t.detach()


def _same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.numel() == 0:
        return True
    as_int = _INT_OF_SIZE[x.element_size()]
    return torch.equal(x.contiguous().view(as_int),
                       y.contiguous().view(as_int))


def _max_abs_diff(x: torch.Tensor, y: torch.Tensor) -> float:
    """max |x - y| in fp64, a bounded slice at a time (no fp64 copy of a
    2 GB leaf on the card)."""
    xf, yf = x.reshape(-1), y.reshape(-1)
    worst = 0.0
    for lo in range(0, xf.numel(), _DIFF_CHUNK):
        d = (xf[lo:lo + _DIFF_CHUNK].double()
             - yf[lo:lo + _DIFF_CHUNK].double()).abs().max()
        worst = max(worst, float(d))
    return worst


def tree_compare(a, b) -> dict:
    """Leaf-by-leaf comparison of two snapshot trees (tensors on any
    device, or host arrays; a host leaf is moved to the other's device).

    Returns {"bitwise": bool, "max_abs_diff": float, "mismatches": [path]}.
    Bitwise means same dtype, same shape, same bytes. ``max_abs_diff`` is
    over float leaves only (an int leaf, a graph index or a hash table,
    either matches or counts as an infinite difference)."""
    fa = flatten(a, with_paths=True)[0]
    fb = flatten(b, with_paths=True)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb], \
        "snapshot structures differ"
    mismatches, max_diff = [], 0.0
    for (path, la), (_, lb) in zip(fa, fb):
        x = _tensor(la)
        y = _tensor(lb, x.device)
        if x.dtype == y.dtype and x.shape == y.shape and _same_bits(x, y):
            continue
        mismatches.append(path)
        if x.shape == y.shape and x.is_floating_point() \
                and y.is_floating_point():
            max_diff = max(max_diff, _max_abs_diff(x, y))
        else:
            max_diff = float("inf")
    return {"bitwise": not mismatches, "max_abs_diff": max_diff,
            "mismatches": mismatches}


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@dataclass
class RecoveryReport:
    head: str
    equivalence: str                  # asserted class: bitwise | trajectory
    kill_at: int
    restored_step: int
    steps_replayed: int               # work lost to the fault (k - restore)
    recovery_s: float                 # fresh experiment + restore, seconds
    bitwise: bool                     # final snapshots byte-identical
    max_abs_diff: float
    mismatches: list = field(default_factory=list)
    loss_max_rel: float = 0.0         # resumed-vs-reference loss rows
    loss_tol: float = 1e-4            # trajectory acceptance bound
    resumed_history: list = field(default_factory=list)
    reference_history: list = field(default_factory=list)
    restore_spans: list = field(default_factory=list)  # "train.restore"
    save_s: float = 0.0               # the victim's "train.checkpoint" spans
    save_fetch_s: float = 0.0         # of save_s: the leaves to the host
    restore_s: float = 0.0            # the resumed run's "train.restore"
    restore_read_s: float = 0.0       # of restore_s: the file read, decoded
    restore_place_s: float = 0.0      # of restore_s: the state placed
    ckpt_bytes: int = 0               # the restored checkpoint file's size
    # elastic (shrink/grow) legs only: zero/empty on same-ring recovery
    reshard_s: float = 0.0            # "train.reshard" span wall-clock
    reshard_bytes_moved: float = 0.0  # "reshard.bytes_moved" counter
    src_mesh: str = ""                # ring the checkpoint was written on
    dst_mesh: str = ""                # ring the resumed run restored onto

    @property
    def ok(self) -> bool:
        if self.equivalence == "bitwise":
            return self.bitwise and self.loss_max_rel == 0.0
        return self.loss_max_rel < self.loss_tol

    def summary(self) -> str:
        elastic = ""
        if self.src_mesh and self.src_mesh != self.dst_mesh:
            elastic = (f" reshard {self.src_mesh}->{self.dst_mesh} "
                       f"{self.reshard_bytes_moved / 1e6:.2f} MB "
                       f"{self.reshard_s * 1e3:.0f} ms;")
        return (f"[{self.head}] kill@{self.kill_at} -> restore@"
                f"{self.restored_step} (+{self.steps_replayed} replayed, "
                f"{self.recovery_s * 1e3:.0f} ms restore)"
                f"{elastic} {self.equivalence}: "
                f"{'OK' if self.ok else 'DIVERGED ' + str(self.mismatches)}")


def _loss_divergence(resumed: list, reference: list) -> float:
    """Max relative loss gap over the steps both histories cover, matched
    on the step index (the victim's rows live in ITS history)."""
    ref = {r["step"]: r["loss"] for r in reference}
    worst = 0.0
    for row in resumed:
        if row["step"] in ref:
            a, b = row["loss"], ref[row["step"]]
            worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
    return worst


def _snapshot_of(exp) -> dict:
    """The experiment's full-state checkpoint tree (both systems)."""
    if hasattr(exp, "trainer"):            # paper system
        return exp.trainer._snapshot()
    return exp._snapshot()                 # zoo system


def _cursor_of(exp) -> int:
    return exp.trainer._t if hasattr(exp, "trainer") else exp._t


def _history_of(exp) -> list:
    return exp.trainer.history if hasattr(exp, "trainer") else exp.history


def _install_tracer(exp, tele) -> None:
    if hasattr(exp, "trainer"):            # paper system
        exp.trainer.telemetry = tele
    else:                                  # zoo system
        exp.telemetry = tele


def _span_s(tracer, name: str) -> float:
    return sum(e.dur_ns for e in tracer.events if e.name == name) * 1e-9


def _free_memory() -> None:
    """After the caller dropped an experiment: collect it (its serving
    engines hold a cycle) and empty the card's cache of freed blocks."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _run_victim(make_exp, ckpt_dir, total_steps, plan, fit_kw) -> tuple:
    """The victim leg: checkpointing, killed by ``plan``. Returns the
    seconds its checkpoints took, and of those its fetches to the host."""
    from repro_torch.telemetry import Tracer
    victim = make_exp(ckpt_dir)
    tele = Tracer()
    _install_tracer(victim, tele)
    try:
        victim.fit(total_steps, step_hook=fault_hook(plan), **fit_kw)
        raise AssertionError(
            f"fault plan {plan} never fired in {total_steps} steps")
    except SimulatedFault:
        pass
    del victim
    _free_memory()
    return (_span_s(tele, "train.checkpoint"),
            tele.counters.get("train.checkpoint.fetch_s", 0.0))


def _resume(make_exp, ckpt_dir, total_steps, fit_kw, tele, *,
            reshard: bool):
    """The resumed leg: a fresh experiment restores the latest checkpoint
    and replays to ``total_steps``. Returns (experiment, restored step,
    seconds from its construction to the end of the restore)."""
    t0 = time.perf_counter()
    resumed = make_exp(ckpt_dir)
    _install_tracer(resumed, tele)
    restored_step = resumed.restore(reshard=reshard)
    recovery_s = time.perf_counter() - t0
    remaining = total_steps - _cursor_of(resumed)
    if remaining > 0:
        resumed.fit(remaining, **fit_kw)
    return resumed, restored_step, recovery_s


def _file_bytes(ckpt_dir: str, step: int) -> int:
    return os.path.getsize(os.path.join(ckpt_dir,
                                        f"ckpt_{step}.msgpack.zst"))


def kill_and_recover(make_exp: Callable[[Optional[str]], object], *,
                     total_steps: int, kill_at: int, ckpt_dir: str,
                     equivalence: str = "bitwise", head: str = "?",
                     fit_kw: Optional[dict] = None,
                     plan: Optional[FaultPlan] = None,
                     telemetry=None, reference=None,
                     before_resume: Optional[Callable[[], None]] = None
                     ) -> RecoveryReport:
    """Run the whole scenario and report.

    ``make_exp(ckpt_dir)`` must build a FRESH experiment (new params)
    writing checkpoints under ``ckpt_dir`` when it is not None: each call
    stands for a separate process. ``fit_kw`` goes to every ``fit`` call.
    ``reference`` is an uninterrupted experiment already run to
    ``total_steps`` (one is built and run when omitted). ``telemetry=``
    (a ``repro_torch.telemetry.Tracer``; one is made when omitted) is
    installed on the resumed experiment; its ``train.restore`` spans land
    in ``RecoveryReport.restore_spans``. ``before_resume()`` is called
    just before the resumed experiment is built (a caller counting what
    the resumed leg launches resets its counters there)."""
    from repro_torch.telemetry import Tracer
    if equivalence not in ("bitwise", "trajectory"):
        raise ValueError(f"unknown equivalence class {equivalence!r}")
    if not 0 < kill_at < total_steps:
        raise ValueError(f"kill_at must be inside (0, {total_steps}), "
                         f"got {kill_at}")
    fit_kw = dict(fit_kw or {})
    plan = plan or FaultPlan(kill_at=kill_at)

    # 1. the uninterrupted reference
    ref = reference
    if ref is None:
        ref = make_exp(None)
        ref.fit(total_steps, **fit_kw)

    # 2. the victim: the same config, checkpointing, killed mid-run
    save_s, fetch_s = _run_victim(make_exp, ckpt_dir, total_steps, plan,
                                  fit_kw)

    # 3. a fresh experiment restores and replays to the end
    tele = telemetry if telemetry is not None else Tracer()
    if before_resume is not None:
        before_resume()
    resumed, restored_step, recovery_s = _resume(
        make_exp, ckpt_dir, total_steps, fit_kw, tele, reshard=False)

    cmp = tree_compare(_snapshot_of(resumed), _snapshot_of(ref))
    return RecoveryReport(
        head=head, equivalence=equivalence, kill_at=kill_at,
        restored_step=restored_step,
        steps_replayed=kill_at - restored_step, recovery_s=recovery_s,
        bitwise=cmp["bitwise"], max_abs_diff=cmp["max_abs_diff"],
        mismatches=cmp["mismatches"],
        loss_max_rel=_loss_divergence(_history_of(resumed),
                                      _history_of(ref)),
        resumed_history=list(_history_of(resumed)),
        reference_history=list(_history_of(ref)),
        restore_spans=[e for e in tele.events if e.name == "train.restore"],
        save_s=save_s, save_fetch_s=fetch_s,
        restore_s=_span_s(tele, "train.restore"),
        restore_read_s=tele.counters.get("train.restore.read_s", 0.0),
        restore_place_s=tele.counters.get("train.restore.place_s", 0.0),
        ckpt_bytes=_file_bytes(ckpt_dir, restored_step),
        src_mesh=_ring(), dst_mesh=_ring())


def _ring() -> str:
    return f"ring of {dist.world_size()}"


# the legs of the elastic harness, each run by every member of its ring


def _reference_leg(make_exp, total_steps: int, fit_kw: dict) -> list:
    ref = make_exp(None)
    return list(ref.fit(total_steps, **fit_kw))


def _victim_leg(make_exp, ckpt_dir: str, total_steps: int, plan,
                fit_kw: dict) -> str:
    _run_victim(make_exp, ckpt_dir, total_steps, plan, fit_kw)
    return _ring()


def _resume_leg(make_exp, ckpt_dir: str, total_steps: int,
                fit_kw: dict) -> dict:
    from repro_torch.telemetry import Tracer
    tele = Tracer()
    resumed, restored_step, recovery_s = _resume(
        make_exp, ckpt_dir, total_steps, fit_kw, tele, reshard=True)
    return {"restored_step": restored_step, "recovery_s": recovery_s,
            "history": list(_history_of(resumed)),
            "spans": [e for e in tele.events
                      if e.name in ("train.restore", "train.reshard")],
            "reshard_s": _span_s(tele, "train.reshard"),
            "bytes_moved": float(tele.counters.get("reshard.bytes_moved",
                                                   0.0)),
            "ring": _ring()}


def elastic_kill_and_recover(
        make_exp: Callable[[Optional[str]], object], *, src_ring: int,
        dst_ring: int, total_steps: int, kill_at: int, ckpt_dir: str,
        head: str = "?", fit_kw: Optional[dict] = None,
        plan: Optional[FaultPlan] = None,
        loss_tol: float = 0.1) -> RecoveryReport:
    """The shrink/grow leg: kill a run on a ring of ``src_ring`` CPU
    processes, resume it on a ring of ``dst_ring`` through the elastic
    reshard, and compare its losses with an uninterrupted reference on the
    destination ring. ``make_exp(ckpt_dir)`` builds an experiment on the
    ring it runs on and must be picklable (a module-level function or a
    ``functools.partial`` of one), since each leg is a ``dist.spawn_ring``.

    The equivalence is ``"trajectory"`` by construction and ``loss_tol``
    is loose by design: the head gradient's scale is proportional to the
    ring size (``dist.psum``'s backward sums one replicated cotangent per
    member, as the JAX trainer's shard_map transpose does), so the
    victim's pre-kill steps ran at the source ring's scale while the
    reference ran at the destination's. The restore itself is exact
    (bitwise dense state). The final snapshots are not compared (the
    ring-shaped aux differs in shape)."""
    if not 0 < kill_at < total_steps:
        raise ValueError(f"kill_at must be inside (0, {total_steps}), "
                         f"got {kill_at}")
    fit_kw = dict(fit_kw or {})
    plan = plan or FaultPlan(kill_at=kill_at)
    ref_hist = dist.spawn_ring(_reference_leg, dst_ring, make_exp,
                               total_steps, fit_kw)[0]
    src_mesh = dist.spawn_ring(_victim_leg, src_ring, make_exp, ckpt_dir,
                               total_steps, plan, fit_kw)[0]
    res = dist.spawn_ring(_resume_leg, dst_ring, make_exp, ckpt_dir,
                          total_steps, fit_kw)[0]
    return RecoveryReport(
        head=head, equivalence="trajectory", kill_at=kill_at,
        restored_step=res["restored_step"],
        steps_replayed=kill_at - res["restored_step"],
        recovery_s=res["recovery_s"], bitwise=False,
        max_abs_diff=float("nan"),
        loss_max_rel=_loss_divergence(res["history"], ref_hist),
        loss_tol=loss_tol, resumed_history=res["history"],
        reference_history=ref_hist, restore_spans=res["spans"],
        restore_s=sum(e.dur_ns for e in res["spans"]
                      if e.name == "train.restore") * 1e-9,
        ckpt_bytes=_file_bytes(ckpt_dir, res["restored_step"]),
        reshard_s=res["reshard_s"], reshard_bytes_moved=res["bytes_moved"],
        src_mesh=src_mesh, dst_mesh=res["ring"])
