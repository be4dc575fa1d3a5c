"""FCCS-driven training loop for the paper system: the port of the JAX
package's ``train/trainer.py``.

Orchestrates the warm-up learning rate, continuous batch growth through
gradient accumulation (quantised to powers of two, as in the JAX package,
where each value is one compiled step), the head's periodic refresh,
periodic checkpoints and evaluation. The trainer never branches on the
head kind.

On a ring every member runs the loop in lockstep on the same global
batches, so every member records the same spans and counters (the
checkpoint's write times are member 0's, the others count 0); the
counter ``train.gather_wait_s`` adds the host seconds a step spent
blocked in the ring's gathers and reduce-scatters (``dist.wait_seconds``:
a blocking call's whole time, a started one's ``wait()``), which the
pipelined schedule (``core.pipeline``) shrinks by what it hides. Member 0
alone prints the step lines.

Checkpoints are FULL-state snapshots in the JAX package's format
(``repro_torch.checkpoint``): the FE params, the head's params AND aux
(the knn graph, the LSH tables, the sketch hashes), the optimizer
moments, DGC's u and v, and the data cursor and step, so a killed run
continues from ``restore_checkpoint`` step for step as if it had never
stopped. The FCCS schedule and the synthetic data stream are functions of
the cursor, so saving the cursor saves the schedule. On a ring, member 0
writes the gathered global tree and every member reads the file and keeps
its block; ``restore_checkpoint(reshard=True)`` takes a checkpoint written
on a ring of another size (``repro_torch.elastic``). ``step_hook`` is the
fault-injection seam (``repro_torch.resilience``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch import dist
from repro_torch.api.experiment import resolve_device
from repro_torch.api.heads import HeadState, make_head
from repro_torch.configs.base import HeadConfig, ModelConfig, TrainConfig
from repro_torch.core import fccs
from repro_torch.telemetry import NULL_TRACER
from repro_torch.train import hybrid

def _pow2_quantize(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def to_device(inputs: dict, device) -> dict:
    """A batch of numpy arrays or tensors, as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v)
                else torch.as_tensor(np.asarray(v))).to(device)
            for k, v in inputs.items()}


@dataclass
class PaperTrainer:
    model_cfg: ModelConfig
    head_cfg: HeadConfig
    train_cfg: TrainConfig
    data_fn: Callable[[int, int], dict]     # (step, global_batch) -> inputs
    hw_batch: int                           # per-update device-limited batch
    device: object = None                   # None = "cuda"; "cpu" on request
    lr_fn: Optional[Callable[[int], float]] = None  # default: FCCS policy
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    ckpt_keep: int = 0                      # 0 = retain every checkpoint
    log_every: int = 10
    seed: int = 0
    history: list = field(default_factory=list)
    telemetry: object = None                # Tracer, or None = NULL_TRACER

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.n_dev = dist.world_size()
        self.head = make_head(self.model_cfg, self.head_cfg)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.state = hybrid.init_state(
            gen, self.model_cfg, self.head_cfg, self.train_cfg, self.n_dev,
            rank=dist.rank(), device=self.device, head=self.head)
        self._steps = {}
        self._t = 0          # data cursor: next step index run() will take
        self.restores = 0    # bumped on every restore (serving-cache probe)
        self.last_reshard = None   # stats dict of the last elastic restore
        self.refresh_head()
        self.eval_step = hybrid.make_eval_step(
            self.model_cfg, self.head_cfg, head=self.head)

    def _get_step(self, n_micro: int):
        if n_micro not in self._steps:
            self._steps[n_micro] = hybrid.make_train_step(
                self.model_cfg, self.head_cfg, self.train_cfg,
                n_micro=n_micro, head=self.head)
        return self._steps[n_micro]

    def refresh_head(self):
        """Paper §3.2.2: suspend training, rebuild the head's aux state,
        resume. Returns the wall-clock spent."""
        tr = self.telemetry or NULL_TRACER
        t0 = time.perf_counter()
        with tr.span("train.refresh"):
            hs = self.head.refresh(HeadState(self.state.head_params,
                                             self.state.head_aux))
            self.state = self.state._replace(head_params=hs.params,
                                             head_aux=hs.aux)
        tr.count("train.refreshes")
        return time.perf_counter() - t0

    # -- full-state checkpoint / restore ----------------------------------

    def _snapshot(self) -> dict:
        """The checkpoint tree: everything the step consumes, plus the
        cursor the loop consumes, GLOBAL (``hybrid.snapshot_tree``; a
        collective on a ring)."""
        return hybrid.snapshot_tree(self.state, self.head, t=self._t,
                                    seed=self.seed)

    def geometry(self):
        """This trainer's ``elastic.MeshGeometry``: the ring is both the
        model and the data axis."""
        from repro_torch.elastic import MeshGeometry
        return MeshGeometry(n_model=self.n_dev, n_data=self.n_dev,
                            n_classes=self.model_cfg.vocab_size)

    def save_checkpoint(self) -> Optional[str]:
        """An atomic full-state snapshot at the current cursor, written by
        member 0 with the ring's geometry as its meta; every member returns
        once the file is complete. Returns the file's path on member 0,
        None on the others."""
        if not self.ckpt_dir:
            raise ValueError("trainer has no ckpt_dir")
        tree = self._snapshot()
        fname = None
        parts = {"fetch_s": 0.0, "write_s": 0.0}
        if dist.rank() == 0:
            meta = {"system": "paper", **self.geometry().meta()}
            self._sync()        # the fetches wait on no pending step
            fname = ckpt_lib.save(self.ckpt_dir, tree, step=self._t,
                                  keep=self.ckpt_keep or None, meta=meta,
                                  timings=parts)
        tr = self.telemetry or NULL_TRACER
        tr.count("train.checkpoint.fetch_s", parts["fetch_s"])
        tr.count("train.checkpoint.write_s", parts["write_s"])
        dist.barrier()
        return fname

    def restore_checkpoint(self, step: Optional[int] = None, *,
                           reshard: bool = False) -> int:
        """Refill the FULL trainer state from ``ckpt_dir`` (the latest step
        by default) and move the cursor, so the next ``run`` continues the
        killed run step for step. ``reshard=True`` accepts a checkpoint
        written on a ring of another size and re-shards it onto this one;
        without it a ring mismatch raises ``ReshardError`` before any leaf
        is decoded. Returns the restored step."""
        if not self.ckpt_dir:
            raise ValueError("trainer has no ckpt_dir")
        from repro_torch import elastic

        tr = self.telemetry or NULL_TRACER
        with tr.span("train.restore"):
            dst = self.geometry()
            src = ckpt_lib.validate_restore(self.ckpt_dir, dst, step,
                                            reshard=reshard)
            # the paths come from this member's own tensors: no gather
            template = hybrid.snapshot_tree(self.state, self.head, t=self._t,
                                            seed=self.seed, gather=False)
            parts = {}
            tree, step = ckpt_lib.restore(self.ckpt_dir, template, step,
                                          timings=parts)
            tr.count("train.restore.read_s", parts["read_s"])
            needs_refresh = False
            if src.n_model != dst.n_model:
                t0 = time.perf_counter()
                with tr.span("train.reshard",
                             attrs={"src": src.describe(),
                                    "dst": dst.describe()}):
                    tree, needs_refresh, led = \
                        elastic.reshard_paper_snapshot(tree, self.head, src,
                                                       dst)
                bytes_moved = led.total_bytes()
                tr.count("reshard.bytes_moved", bytes_moved)
                self.last_reshard = {
                    "src": src, "dst": dst,
                    "plan": elastic.plan_reshard(src, dst).describe(),
                    "bytes_moved": bytes_moved, "ledger": led,
                    "seconds": time.perf_counter() - t0}
            t0 = time.perf_counter()
            self.state = hybrid.state_from_snapshot(
                tree, aux_spec=self.head.aux_spec(), rank=dist.rank(),
                world_size=self.n_dev, device=self.device)
            self._sync()
            tr.count("train.restore.place_s", time.perf_counter() - t0)
            self._t = int(tree["extra"]["t"])
            self.restores += 1
            tr.count("train.restores")
            if needs_refresh:
                # aux with no exact re-pack rule: the head's own refresh
                # on the dst ring
                self.refresh_head()
        return step

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, total_steps: int, *, use_fccs_batch: bool = True,
            step_hook: Optional[Callable[[int], None]] = None):
        """Run ``total_steps`` MORE steps from the current cursor (0 for a
        fresh trainer; the restored step after ``restore_checkpoint``).
        ``step_hook(t)`` fires before each step; whatever it raises
        propagates after any due checkpoint of the previous step was
        written."""
        fcfg = self.train_cfg.fccs
        refresh_every = self.head.refresh_every
        start = self._t
        tr = self.telemetry or NULL_TRACER
        for t in range(start, start + total_steps):
            if step_hook is not None:
                step_hook(t)
            lr = (self.lr_fn(t) if self.lr_fn is not None
                  else fccs.learning_rate(t, fcfg))
            n = (_pow2_quantize(fccs.accum_steps(t, fcfg, self.hw_batch))
                 if use_fccs_batch else 1)
            with tr.span("train.data"):
                inputs = to_device(self.data_fn(t, self.hw_batch * n),
                                   self.device)
                step = self._get_step(n)
            waited = dist.wait_seconds()
            with tr.span("train.step"):
                self.state, loss, metrics = step(self.state, inputs, lr)
                if tr.enabled:
                    # kernels run asynchronously: only a live tracer pays
                    # for the sync that makes the span cover them
                    self._sync()
            waited = dist.wait_seconds() - waited
            tr.count("train.steps")
            tr.count("train.gather_wait_s", waited)
            self._t = t + 1
            if refresh_every and (t + 1) % refresh_every == 0:
                self.refresh_head()
            if self.ckpt_dir and self.ckpt_every and \
                    (t + 1) % self.ckpt_every == 0:
                with tr.span("train.checkpoint"):
                    self.save_checkpoint()
                tr.count("train.checkpoints")
            row = {"step": t, "lr": lr, "batch": self.hw_batch * n,
                   "loss": float(loss),
                   "acc": float(metrics["accuracy"])}
            # the head's own metrics beyond accuracy and logz (knn and
            # selective: active_frac, label_recall; sampled: sample_frac),
            # averaged over the micro-batches
            row.update({k: float(metrics[k]) for k in self.head.metrics_spec()
                        if k not in ("accuracy", "logz")})
            self.history.append(row)
            tr.log_metrics({**row, "gather_wait_s": waited})
            if self.log_every and t % self.log_every == 0 and \
                    dist.rank() == 0:
                print(f"[train] step={t} lr={lr:.4f} B={row['batch']} "
                      f"loss={row['loss']:.4f} acc={row['acc']:.3f}")
        tr.record_peak_memory()
        return self.history

    def evaluate(self, eval_inputs) -> float:
        return float(self.eval_step(self.state,
                                    to_device(eval_inputs, self.device)))
