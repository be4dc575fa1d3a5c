"""A counter of a step's work: the port's counterpart of the JAX
package's ``roofline/hlo.py``.

Where the JAX package parses the compiled HLO of a step, the port counts
the step as it runs, in a ``TorchDispatchMode`` that sees every aten op
below autograd (forward, backward, the update), on meta, CPU and CUDA
tensors alike:

  flops        the products' operations (``torch.utils.flop_counter``'s
               formulas: mm, bmm, addmm, baddbmm, convolutions and their
               backwards; elementwise work is not counted, as in
               ``hlo.py``), by rate class: bf16 / fp16 operands on the
               tensor cores, fp32 on the CUDA cores (TF32 where the
               backends allow it), plus what each hand-written kernel's
               cost function charges (``kernels.cost``; ctypes launches
               are invisible to a dispatch mode);
  bytes        the inputs and outputs of every op that is not a view (an
               op reads each input once and writes each output once), and
               the kernels' charged bytes. In eager mode each op moves
               its operands through memory, so this is an upper bound
               next to a fused XLA program's ``bytes accessed``;
  collectives  ``dist.count_collectives``'s bytes by kind: one ring
               member's, as the HLO of one device's program;
  peak_bytes   with ``track_memory``, the most bytes of storage alive at
               once: every storage an op makes counts from its creation
               until the last tensor on it dies (``weakref.finalize`` on
               the storage), and those given to ``hold`` from then on.
               Meta tensors have no allocator; this is the dry run's
               peak, which ``chip_smoke.py`` holds against
               ``torch.cuda.max_memory_allocated`` of the real step.

One member's numbers: on a ring of P each member runs this program.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import dist
from repro_torch.kernels import cost as kcost
from repro_torch.roofline.hardware import HBM_BW, LINK_BW, RATES

_aten = torch.ops.aten
# ops that move no bytes of their own: allocations, aliases, metadata
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided, _aten.detach,
             _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
             _aten.set_, _aten.resize_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rate(func, args) -> str:
    """The rate class of a product: its first tensor operand's dtype."""
    dt = next((a.dtype for a in tree_flatten(args)[0]
               if isinstance(a, torch.Tensor)), torch.float32)
    if dt in (torch.bfloat16, torch.float16):
        return "bf16"
    conv = "conv" in func.__name__
    tf32 = (torch.backends.cudnn.allow_tf32 if conv
            else torch.backends.cuda.matmul.allow_tf32)
    return "tf32" if tf32 else "fp32"


class WorkCounter(TorchDispatchMode):
    """``with WorkCounter() as wc: step(...)``, then ``wc.result()``.
    ``track_memory``: also the peak of live storage bytes (module
    docstring); give ``hold`` what lives before the step."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.flops_by_rate = defaultdict(float)
        self.bytes = 0.0
        self.n_ops = 0
        self.kernels: dict = {}
        self.paused = 0
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._counts = None
        self._dist_cm = None

    # -- memory -----------------------------------------------------------

    def _free(self, key: int, nbytes: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def hold(self, *trees) -> int:
        """Count the tensors of ``trees`` as alive from now on (the
        step's arguments); returns their bytes (each storage once)."""
        before = self.live
        for t in tree_flatten(trees)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return self.live - before

    # -- counting ---------------------------------------------------------

    def charge_kernel(self, name: str, c: "kcost.Cost") -> None:
        """One call of a hand-written kernel (``kernels.cost.charges``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0.0,
                                           "bytes": 0.0, "rate": c.rate})
        k["calls"] += 1
        k["ops"] += c.ops
        k["bytes"] += c.bytes
        self.flops_by_rate[c.rate] += c.ops
        self.bytes += c.bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self.n_ops += 1
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops_by_rate[_rate(packet, args)] += float(
                    flop_registry[packet](*args, **kwargs, out_val=out))
            if not (func.is_view or packet in _NO_BYTES):
                self.bytes += sum(
                    _nbytes(t) for t in tree_flatten((args, kwargs, out))[0]
                    if isinstance(t, torch.Tensor))
        if self.track_memory:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def __enter__(self):
        kcost.COUNTERS.append(self)
        self._dist_cm = dist.count_collectives()
        self._counts = self._dist_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._dist_cm.__exit__(*exc)
            kcost.COUNTERS.remove(self)

    # -- the record -------------------------------------------------------

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_rate.values()))

    def compute_s(self) -> float:
        """Each rate class's operations over its peak rate, summed."""
        return sum(v / RATES[r] for r, v in self.flops_by_rate.items())

    def result(self) -> dict:
        """The counts in the dry run's record layout: ``counted`` (flops,
        flops_by_rate, bytes, ops), ``kernels``, ``collectives``, and the
        roofline's three terms in seconds."""
        coll = {k: v for k, v in (self._counts or {}).items()}
        coll.setdefault("total_bytes", 0.0)
        return {
            "counted": {"flops": self.flops,
                        "flops_by_rate": dict(self.flops_by_rate),
                        "bytes": self.bytes, "ops": self.n_ops},
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "collectives": coll,
            "terms_s": {"compute": self.compute_s(),
                        "memory": self.bytes / HBM_BW,
                        "collective": coll["total_bytes"] / LINK_BW},
        }
