"""Three-term roofline of a dry-run or counted step record, on an H100:
the port of the JAX package's ``roofline/analysis.py``.

    compute term    = counted FLOPs of each rate class / its peak rate
    memory term     = counted bytes / HBM bandwidth
    collective term = collective bytes / NVLink bandwidth (one direction)

The counts are one ring member's (``roofline.counter``; the JAX package
reads the per-device HLO), so every term is a per-card time. The rates
are the H100 SXM's (``roofline.hardware``), where the JAX package's are a
TPU v5e's: 989 TFLOP/s bf16 (67 fp32 on the CUDA cores, 494.7 TF32),
3.35 TB/s HBM, 450 GB/s NVLink each way, 80 GB to fit in.

MODEL_FLOPS (the useful work) is analytic, as there: 6 N D for training
(N params, D tokens), 6 N_active D for MoE, 2 N (+ attention) for a
prefill or a decode step. Its ratio to the counted FLOPs of all cards
shows remat's recompute, the head's logits work and padded expert
capacity.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig,
                                      get_model_config, normalize_arch_id)
from repro_torch.roofline.hardware import (BF16_FLOPS, HBM_BW, HBM_BYTES,
                                           LINK_BW, RATES)

PEAK_FLOPS = BF16_FLOPS    # dense bf16 / card (the JAX module's name)


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS
# ---------------------------------------------------------------------------


def active_params(cfg: ModelConfig) -> float:
    """Total params, counting only the top-k (+ shared) experts for MoE.
    The model is built on the meta device (``lm.abstract_model``)."""
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves
    total = sum(t.numel() for t in tree_leaves(lm.abstract_model(cfg)))
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    expert_p = cfg.n_layers * 3 * cfg.d_model * m.d_ff * m.n_experts
    active_expert_p = expert_p * (m.top_k / m.n_experts)
    return float(total - expert_p + active_expert_p)


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Analytic useful FLOPs of one GLOBAL step (all cards together)."""
    shape = INPUT_SHAPES[shape_name]
    n_act = active_params(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * (1 if cfg.family == "cnn"
                                       else shape.seq_len)
        flops = 6.0 * n_act * tokens
        # causal attention score / context products (not in 6ND)
        if cfg.n_heads and cfg.family != "cnn":
            hd = cfg.resolved_head_dim
            win = cfg.sliding_window or shape.seq_len
            eff = min(win, shape.seq_len)
            flops += (6.0 * 2.0 * shape.global_batch * cfg.n_layers
                      * cfg.n_heads * hd * shape.seq_len * eff / 2)
        return flops
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        flops = 2.0 * n_act * tokens
        if cfg.n_heads and cfg.family != "cnn":
            hd = cfg.resolved_head_dim
            win = cfg.sliding_window or shape.seq_len
            eff = min(win, shape.seq_len)
            flops += (2.0 * 2.0 * shape.global_batch * cfg.n_layers
                      * cfg.n_heads * hd * shape.seq_len * eff / 2)
        return flops
    # decode: one token per sequence
    flops = 2.0 * n_act * shape.global_batch
    if cfg.n_heads and cfg.family != "ssm":
        hd = cfg.resolved_head_dim
        win = cfg.sliding_window or shape.seq_len
        kv_len = min(win, shape.seq_len)
        flops += (2.0 * 2.0 * shape.global_batch * cfg.n_layers
                  * cfg.n_heads * hd * kv_len)
    return flops


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_dev: float       # the counted FLOPs of one card
    useful_ratio: float
    peak_gib: float
    fits: bool

    def terms(self):
        return {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}


def mesh_chips(mesh: str) -> int:
    """Cards of a record's mesh: "16x16" -> 256, "1x4" -> 4, "256" ->
    256."""
    n = 1
    for part in str(mesh).split("x"):
        n *= int(part)
    return n


def compute_seconds(counted: dict) -> float:
    """Each rate class's FLOPs over its peak (bf16 when unclassed)."""
    by = counted.get("flops_by_rate")
    if not by:
        return counted["flops"] / PEAK_FLOPS
    return sum(v / RATES[r] for r, v in by.items())


def analyze_record(rec: dict) -> Optional[RooflineRow]:
    """A dry-run record (``launch.dryrun``) as a roofline row; None for a
    failed one. ``model_flops`` comes from the record where it carries
    one (the paper's records), else from the arch's config."""
    if "error" in rec:
        return None
    n_chips = mesh_chips(rec["mesh"])
    counted = rec["counted"]
    compute_s = compute_seconds(counted)
    memory_s = counted["bytes"] / HBM_BW
    coll_s = rec["collectives"]["total_bytes"] / LINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", coll_s)), key=lambda kv: kv[1])[0]
    if "model_flops" in rec:
        mf = float(rec["model_flops"])
    else:
        mf = model_flops(get_model_config(normalize_arch_id(rec["arch"])),
                         rec["shape"])
    useful = mf / max(counted["flops"] * n_chips, 1.0)
    mem = rec["memory"]
    per_dev = max(mem["argument_bytes"], mem.get("peak_bytes", 0))
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        n_chips=n_chips, compute_s=compute_s, memory_s=memory_s,
        collective_s=coll_s, dominant=dominant, model_flops=mf,
        hlo_flops_per_dev=counted["flops"], useful_ratio=useful,
        peak_gib=per_dev / 2**30, fits=per_dev <= HBM_BYTES)


def load_rows(path: str, mesh: Optional[str] = None):
    rows = []
    seen = set()
    for line in open(path):
        rec = json.loads(line)
        key = (rec.get("arch"), rec.get("shape"), rec.get("mesh"),
               rec.get("knn", False), rec.get("remat"), rec.get("head"))
        if key in seen:
            continue
        seen.add(key)
        if mesh and rec.get("mesh") != mesh:
            continue
        row = analyze_record(rec)
        if row:
            rows.append(row)
    return rows


def bottleneck_sentence(row: RooflineRow) -> str:
    """One sentence on what would move the dominant term down."""
    if row.dominant == "collective":
        return ("collective-bound: cut the bytes that cross cards (KNN "
                "softmax's active classes shrink the head's work and the "
                "gathers; DGC shrinks the trunk's gradient exchange; larger "
                "micro-batches amortise the gathers)")
    if row.dominant == "memory":
        return ("HBM-bound: raise arithmetic intensity (fuse the eager "
                "step's elementwise passes and casts, stream the softmax in "
                "the CE kernels, bf16 activations end to end)")
    return ("compute-bound: good — push the products onto the bf16 tensor "
            "cores and drop redundant compute (remat's recompute, padded "
            "expert capacity)")


def to_markdown(rows, hillclimbed=()) -> str:
    out = ["| arch | shape | mesh | compute(s) | memory(s) | collective(s) | "
           "dominant | MODEL_FLOPS | useful | peak GiB/card | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r.arch, r.shape, r.mesh)):
        mark = " **(hillclimbed)**" if (r.arch, r.shape) in hillclimbed else ""
        out.append(
            f"| {r.arch}{mark} | {r.shape} | {r.mesh} | {r.compute_s:.2e} | "
            f"{r.memory_s:.2e} | {r.collective_s:.2e} | {r.dominant} | "
            f"{r.model_flops:.2e} | {r.useful_ratio:.2f} | "
            f"{r.peak_gib:.1f} | {'yes' if r.fits else 'NO'} |")
    return "\n".join(out)

