"""What each hand-written kernel must do, and charging it to a counter.

The kernels launch through ctypes, which no ``TorchDispatchMode`` sees,
so each kernel module has a cost function: the operations and the bytes
of one call at the given shapes (each input read once, each output
written once), at the rate class of the work (``"tf32"`` for the CE
kernels' 3xTF32 products, three TF32 products for each fp32 one;
``"bf16"``; ``"fp32"`` on the CUDA cores). ``bound_ms`` turns a cost into
the least time the card could take (``roofline.hardware``), and
``chip_smoke.py`` prints that bound beside each kernel's time.

Each wrapper is decorated with ``charges(name, cost_of)``: with a
``roofline.counter.WorkCounter`` active a call charges its cost, and the
counter does not count the ops the wrapper runs meanwhile (its plain
version on the CPU, its output allocations on the card), so a step counts
the same on meta, CPU and CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from repro_torch.roofline.hardware import HBM_BW, RATES

# the active work counters (``roofline.counter.WorkCounter`` registers
# itself on entry)
COUNTERS: list = []


class Cost(NamedTuple):
    ops: float        # operations at ``rate``
    bytes: float      # each input read once, each output written once
    rate: str         # "bf16" | "tf32" | "fp32" (roofline.hardware.RATES)


def bound_ms(cost: Cost) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over the rate of their class."""
    t_bytes = cost.bytes / HBM_BW * 1e3
    t_ops = cost.ops / RATES[cost.rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32x3(n_bytes: float, n_products: int, b: int, cols: int,
           d: int) -> Cost:
    """A CE kernel's cost: ``n_products`` fp32 products of 2 b cols d
    operations each, taken as three TF32 products (the kernels' design)."""
    return Cost(3 * n_products * 2.0 * b * cols * d, float(n_bytes), "tf32")


def as_fp32_fma(cost: Cost) -> Cost:
    """A 3xTF32 cost as the same products on the CUDA cores in fp32."""
    return cost._replace(ops=cost.ops / 3, rate="fp32")


def charges(name: str, cost_of: Callable[..., Cost]):
    """Decorate a kernel's wrapper: while a counter is active, each call
    charges ``cost_of(*args, **kwargs)`` to it as one call of kernel
    ``name``, and the counter leaves the ops run inside uncounted."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            active = list(COUNTERS)
            if not active:
                return fn(*args, **kwargs)
            cost = cost_of(*args, **kwargs)
            for c in active:
                c.charge_kernel(name, cost)
                c.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                for c in active:
                    c.paused -= 1
        return run
    return wrap
