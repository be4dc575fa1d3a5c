"""FCCS-driven training loop for the paper system: the port of the JAX
package's ``train/trainer.py`` without checkpoints.

Orchestrates the warm-up learning rate, continuous batch growth through
gradient accumulation (quantised to powers of two, as in the JAX package,
where each value is one compiled step), the head's periodic refresh and
evaluation. The trainer never branches on the head kind.

Checkpoints, ``restore_checkpoint`` and elastic restore are not ported yet
(ROADMAP.md queue A.7): asking for them raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import dist
from repro_torch.api.experiment import resolve_device
from repro_torch.api.heads import HeadState, make_head
from repro_torch.configs.base import HeadConfig, ModelConfig, TrainConfig
from repro_torch.core import fccs
from repro_torch.telemetry import NULL_TRACER
from repro_torch.train import hybrid

_NO_CKPT = ("checkpoints are not ported to torch yet (ROADMAP.md queue "
            "A.7)")


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
    log_every: int = 10
    seed: int = 0
    history: list = field(default_factory=list)
    telemetry: object = None                # Tracer, or None = NULL_TRACER

    def __post_init__(self):
        if self.ckpt_dir:
            raise NotImplementedError(_NO_CKPT)
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

    def restore_checkpoint(self, step: Optional[int] = None, *,
                           reshard: bool = False) -> int:
        raise NotImplementedError(_NO_CKPT)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, total_steps: int, *, use_fccs_batch: bool = True,
            step_hook: Optional[Callable[[int], None]] = None):
        """Run ``total_steps`` MORE steps from the current cursor.
        ``step_hook(t)`` fires before each step."""
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
            with tr.span("train.step"):
                self.state, loss, metrics = step(self.state, inputs, lr)
                if tr.enabled:
                    # kernels run asynchronously: only a live tracer pays
                    # for the sync that makes the span cover them
                    self._sync()
            tr.count("train.steps")
            self._t = t + 1
            if refresh_every and (t + 1) % refresh_every == 0:
                self.refresh_head()
            row = {"step": t, "lr": lr, "batch": self.hw_batch * n,
                   "loss": float(loss),
                   "acc": float(metrics["accuracy"])}
            # the head's own metrics beyond accuracy and logz (knn and
            # selective: active_frac, label_recall; sampled: sample_frac),
            # averaged over the micro-batches
            row.update({k: float(metrics[k]) for k in self.head.metrics_spec()
                        if k not in ("accuracy", "logz")})
            self.history.append(row)
            tr.log_metrics(row)
            if self.log_every and t % self.log_every == 0:
                print(f"[train] step={t} lr={lr:.4f} B={row['batch']} "
                      f"loss={row['loss']:.4f} acc={row['acc']:.3f}")
        tr.record_peak_memory()
        return self.history

    def evaluate(self, eval_inputs) -> float:
        return float(self.eval_step(self.state,
                                    to_device(eval_inputs, self.device)))
