#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA. Phases, each of which fails the run:

1. build: ``nvcc`` compiles every ``src/repro_torch/kernels/csrc/*.cu``
   into ``build/repro_torch_kernels/`` (one process per source, in
   parallel) and prints ``-Xptxas -v``'s register report.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the same card tensors, at the serving shapes of the paper's 1M-class
   configuration (B=64, V=1,020,250, D=512) and at small ragged shapes
   with masked columns, labels off the shard, ties and -inf rows.
   Tolerances: ``ce_forward`` m and corr atol 1e-4, z rtol 1e-4, amax
   equal except on rows whose top-2 score gap is below 1e-5 (fp32 sums in
   another order may swap a near-tie); ``stage1_topk`` values and ids
   exact. Then CUDA-event times of the kernel, its plain version, the
   library call that computes the same function where one exists, and
   the bound (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s,
   the H100 SXM data sheet's rates, whichever is larger).
3. serving (the main path): ``Experiment.from_config(system="paper",
   classes=1_020_250, feat_dim=512)`` with the ``full`` head on the
   ``kernel`` backend, random weights from a seed; ``serve(batch=64)`` and
   ``serve(batch=64, top_k=5, return_scores=True)`` through the serving
   engine, with every kernel's launch counter set to 0 just before and
   read just after (each must have launched). The results are checked
   for shape, range and order, against the ``ref`` backend on the same
   weights and queries, and greedy ids against the top-1 of the top-5.
4. launcher: ``repro_torch.launch.serve`` replaying 0.5 s of the bursty
   Zipfian trace through the engine at the same width.

It prints the card's name and power limit, one ``{"kernels": [...]}``
line, one ``{"end_to_end": ...}`` line and, last, ``{"ok": true,
"device": {...}}``. Without a CUDA card, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
B, V, D, K = 64, 1_020_250, 512, 5          # configs/sku100m_resnet.config_1m
CHUNK = 2048                                 # ops.topk_rows' chunk
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                       # H100 SXM, outside tensor cores


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up,
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Median host wall-clock of ``fn`` (which returns host arrays), after
    a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_ms(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host wall-clock,
    the device time of the kernels it ran, the device's idle share, and
    the costliest kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the first profiled call of a process also pays the tracer's set-up
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in kernels)
    if busy <= 0:
        fail("the profiler saw no device time in a serve call")
    top = sorted(kernels, key=lambda k: -k[1])[:6]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top_kernels_ms": {name[:60]: ms for name, ms in top}}


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def check_ce(torch, ce, f, w, y, limit, scale=1.0, label=""):
    """ce_forward's kernel vs ce_forward_plain on the same card tensors.
    Returns the largest absolute error of m and corr, and the largest
    relative error of z."""
    m1, z1, c1, a1 = ce.ce_forward(f, w, y, limit=limit, scale=scale)
    yl = torch.where((y >= 0) & (y < w.shape[0]), y, -1).to(torch.int32)
    lim = max(0, min(int(limit), w.shape[0]))
    m2, z2, c2, a2 = ce.ce_forward_plain(f, w, yl, lim, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(m1, m2, atol=1e-4, rtol=0,
                               msg=lambda s: f"ce_forward m {label}: {s}")
    torch.testing.assert_close(c1, c2, atol=1e-4, rtol=0,
                               msg=lambda s: f"ce_forward corr {label}: {s}")
    torch.testing.assert_close(z1, z2, rtol=1e-4, atol=0,
                               msg=lambda s: f"ce_forward z {label}: {s}")
    s = (f @ w.T) * scale
    s[:, lim:] = float("-inf")
    top2 = s.topk(min(2, s.shape[1]), dim=1).values
    gap = (top2[:, 0] - top2[:, -1]) if top2.shape[1] > 1 else None
    differ = a1 != a2
    if gap is not None:
        differ &= ~(gap < 1e-5)
    if bool(differ.any()):
        rows = differ.nonzero()[:, 0].tolist()[:8]
        fail(f"ce_forward amax {label}: rows {rows} kernel "
             f"{a1[rows].tolist()} plain {a2[rows].tolist()}")
    def worst(e):
        e = e[torch.isfinite(e)]
        return float(e.abs().max()) if e.numel() else 0.0

    # m and corr are scores; z is a sum over V terms, so its error is
    # relative
    return (max(worst(m1 - m2), worst(c1 - c2)),
            worst((z1 - z2) / z2.clamp_min(torch.finfo(z2.dtype).tiny)))


def check_topk(torch, dc, x, k, chunk=None, label=""):
    v1, i1 = dc.stage1_topk(x, k, chunk=chunk)
    v2, i2 = dc.stage1_topk_plain(x, k, chunk)
    torch.cuda.synchronize()
    if not torch.equal(v1, v2):
        bad = (v1 != v2).any(dim=1).nonzero()[:4, 0].tolist()
        fail(f"stage1_topk values {label}: rows {bad} kernel "
             f"{v1[bad].tolist()} plain {v2[bad].tolist()}")
    if not torch.equal(i1, i2):
        bad = (i1 != i2).any(dim=1).nonzero()[:4, 0].tolist()
        fail(f"stage1_topk ids {label}: rows {bad} kernel "
             f"{i1[bad].tolist()} plain {i2[bad].tolist()}")
    return 0.0


def kernel_phase(torch, ce, dc, sharded):
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    # -- small ragged shapes: masking, labels off the shard, ties, -inf ----
    b, v, d = 37, 5013, 36
    f = torch.randn((b, d), generator=g, device=dev)
    w = torch.randn((v, d), generator=g, device=dev) * 0.1
    y = torch.randint(0, v, (b,), generator=g, device=dev, dtype=torch.int32)
    y[:4] = torch.tensor([-1, v + 3, v - 1, 4500], device=dev,
                         dtype=torch.int32)      # off shard, masked column
    check_ce(torch, ce, f, w, y, v, 1.0, "ragged")
    check_ce(torch, ce, f, w, y, 4000, 16.0, "ragged limit=4000")
    check_ce(torch, ce, f, w, y, 0, 1.0, "all masked")
    fb = torch.randn((200, d), generator=g, device=dev)  # 4 batch tiles
    yb = torch.randint(-1, v, (200,), generator=g, device=dev,
                       dtype=torch.int32)
    check_ce(torch, ce, fb, w[:100].contiguous(), yb, 100, 1.0,
             "200 rows x 100 classes")
    # integer-valued inputs make every product exact, so duplicated rows
    # tie exactly and amax must take the lowest column
    fi = torch.randint(-3, 4, (b, d), generator=g, device=dev).float()
    wi = torch.randint(-3, 4, (v, d), generator=g, device=dev).float()
    wi[4000:4100] = wi[17]
    wi[2500] = wi[17]
    m, _, _, a = ce.ce_forward(fi, wi, y, limit=v)
    m2, _, _, a2 = ce.ce_forward_plain(fi, wi, torch.where(
        (y >= 0) & (y < v), y, -1), v)
    if not (torch.equal(a, a2) and torch.equal(m, m2)):
        fail("ce_forward ties: amax or m differ from the plain version")

    x = torch.randn((7, 3000), generator=g, device=dev)
    x = torch.round(x * 4) / 4                   # many exact ties
    x[2] = float("-inf")                         # a row with nothing
    x[3, 100:] = float("-inf")                   # a row short of k
    check_topk(torch, dc, x, 7, 512, "ragged chunks")
    check_topk(torch, dc, x[:, :100].contiguous(), 5, None, "n <= chunk")
    check_topk(torch, dc, x, 16, 2048, "ragged 2048")
    check_topk(torch, dc, x[:, :2500], 7, 512, "strided rows")
    log("kernel phase: ragged shapes agree with the plain versions")

    # -- the serving shapes ------------------------------------------------
    fs = sharded._normalize(torch.randn((B, D), generator=g, device=dev))
    ws = sharded._normalize(torch.randn((V, D), generator=g, device=dev))
    ys = torch.randint(0, V, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    ys[::7] = -1
    ce_err, z_rel = check_ce(torch, ce, fs, ws, ys, V, 1.0, "serving shapes")
    logits = fs @ ws.T
    tk_err = check_topk(torch, dc, logits, K, CHUNK, "serving shapes")
    log(f"kernel phase: serving shapes agree (ce_forward m/corr max abs "
        f"err {ce_err:.3g}, z max rel err {z_rel:.3g})")

    yl = torch.where(ys >= 0, ys, -1)
    ce_ms = cuda_ms(torch, lambda: ce.ce_forward(fs, ws, ys, limit=V), 20)
    ce_plain = cuda_ms(torch, lambda: ce.ce_forward_plain(fs, ws, yl, V), 5)
    nch = -(-V // CHUNK)
    tk_ms = cuda_ms(torch, lambda: dc.stage1_topk(logits, K, chunk=CHUNK), 50)
    tk_plain = cuda_ms(torch, lambda: dc.stage1_topk_plain(logits, K, CHUNK),
                       5)
    padded = torch.nn.functional.pad(logits, (0, nch * CHUNK - V),
                                     value=float("-inf")).reshape(-1, CHUNK)
    tk_lib = cuda_ms(torch, lambda: torch.topk(padded, K, dim=1), 50)

    ce_bytes = 4 * (B * D + V * D + B) + 16 * B
    ce_bound, ce_by = bound_ms(ce_bytes, 2.0 * B * V * D)
    tk_bytes = 4 * B * V + 8 * B * nch * K
    tk_bound, tk_by = bound_ms(tk_bytes, float(K) * B * V)
    return {
        "ce_forward": dict(
            name="ce_forward", route="cuda",
            source="src/repro_torch/kernels/csrc/ce_softmax_fwd.cu",
            replaces="src/repro/kernels/ce_softmax.py:106",
            max_abs_err=ce_err, z_max_rel_err=z_rel, ms=ce_ms,
            plain_ms=ce_plain, bound_ms=ce_bound, bound_by=ce_by,
            library_ms=None,
            shape=f"f[{B},{D}] W[{V},{D}]"),
        "stage1_topk": dict(
            name="stage1_topk", route="cuda",
            source="src/repro_torch/kernels/csrc/topk_stage1.cu",
            replaces="src/repro/kernels/topk_dc.py:46",
            max_abs_err=tk_err, ms=tk_ms, plain_ms=tk_plain,
            bound_ms=tk_bound, bound_by=tk_by, library_ms=tk_lib,
            shape=f"x[{B},{V}] chunk {CHUNK} k {K}"),
    }


# ---------------------------------------------------------------------------
# serving phase (the main path) and launcher phase
# ---------------------------------------------------------------------------


def serving_phase(torch, np, ce, dc, sharded):
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig
    from repro_torch.train import hybrid

    t0 = time.perf_counter()
    exp = Experiment.from_config(
        system="paper", classes=V, feat_dim=D, batch=B, seed=0,
        device=DEVICE, head=HeadConfig(softmax_impl="full", backend="kernel"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"serving phase: experiment with W {tuple(exp.state.w_head.shape)} "
        f"on {exp.device} in {setup_s:.1f} s")

    ce.LAUNCHES = 0
    dc.LAUNCHES = 0
    ids = exp.serve(batch=B)
    tids, tscores = exp.serve(batch=B, top_k=K, return_scores=True)
    launches = {"ce_forward": ce.LAUNCHES, "stage1_topk": dc.LAUNCHES}
    for name, n in launches.items():
        if n < 1:
            fail(f"the serving path never launched {name}")
    log(f"serving phase: launches on the main path {launches}")

    if ids.shape != (B,) or tids.shape != (B, K) or tscores.shape != (B, K):
        fail(f"result shapes {ids.shape} {tids.shape} {tscores.shape}")
    if not (np.all((ids >= 0) & (ids < V)) and np.all((tids >= 0)
                                                      & (tids < V))):
        fail("class ids out of range")
    if not np.all(np.isfinite(tscores)) or np.any(np.diff(tscores, 1) > 0):
        fail("top-k scores not finite or not descending")

    # the same queries through the ref backend, on the same weights
    q = exp.data_fn(10**6, B)["features"]
    ref_cfg = dataclasses.replace(exp.head_cfg, backend="ref")
    greedy_ref = hybrid.make_batched_serve_step(exp.model_cfg, ref_cfg)
    topk_ref = hybrid.make_batched_topk_serve_step(exp.model_cfg, ref_cfg, K)
    rids = greedy_ref(exp.state, q, B).cpu().numpy()
    rvals, rgids = (t.cpu().numpy() for t in topk_ref(exp.state, q, B))
    # rows whose best two cosine scores lie within 1e-5 may swap
    near_tie = (rvals[:, 0] - rvals[:, 1]) < 1e-5
    bad = (ids != rids) & ~near_tie
    if bad.any():
        fail(f"greedy ids differ from the ref backend on rows "
             f"{np.nonzero(bad)[0][:8].tolist()}")
    if not np.array_equal(ids[~near_tie], tids[~near_tie, 0]):
        fail("greedy ids are not the top-1 of the top-k")
    close = np.abs(tscores - rvals) <= 1e-5
    if not close.all():
        fail(f"top-k scores differ from the ref backend by up to "
             f"{np.abs(tscores - rvals).max():.3g}")
    gaps = np.diff(rvals, axis=1) > -1e-5       # adjacent near-ties
    same = (tids == rgids) | np.pad(gaps, ((0, 0), (0, 1))) | np.pad(
        gaps, ((0, 0), (1, 0)))
    if not same.all():
        fail("top-k ids differ from the ref backend")
    max_err = float(np.abs(tscores - rvals).max())
    log(f"serving phase: kernel backend agrees with ref (top-k score max "
        f"abs err {max_err:.3g}; near-tie rows {int(near_tie.sum())})")

    acc = exp.evaluate(eval_batch=B)
    if not 0.0 <= acc <= 1.0:
        fail(f"evaluate() returned {acc}")

    e2e = {
        "setup_s": setup_s,
        "greedy_ms": host_ms(torch, lambda: exp.serve(batch=B), 10),
        "top5_ms": host_ms(torch, lambda: exp.serve(batch=B, top_k=K,
                                                    return_scores=True), 10),
        "normalize_w_ms": cuda_ms(
            torch, lambda: sharded._normalize(exp.state.w_head), 10),
        "dense_logits_ms": cuda_ms(
            torch, lambda: q @ exp.state.w_head.T, 10),
        "evaluate_accuracy": acc,
        "top5_score_max_abs_err_vs_ref": max_err,
        "greedy_profile": profile_ms(torch, lambda: exp.serve(batch=B)),
        "top5_profile": profile_ms(torch, lambda: exp.serve(
            batch=B, top_k=K, return_scores=True)),
    }
    return exp, launches, e2e


def launcher_phase(torch, ce, dc):
    from repro_torch.launch import serve as launcher

    metrics = ROOT / "build" / "chip_smoke" / "replay_metrics.jsonl"
    metrics.parent.mkdir(parents=True, exist_ok=True)
    metrics.unlink(missing_ok=True)
    before = (ce.LAUNCHES, dc.LAUNCHES)
    rc = launcher.main(["--system", "paper", "--classes", str(V),
                        "--feat-dim", str(D), "--topk", str(K),
                        "--batch", str(B), "--replay", "0.5",
                        "--device", DEVICE,
                        "--metrics-out", str(metrics)])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"launcher returned {rc}")
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    if not rows or rows[-1].get("n", 0) < 1:
        fail("the launcher's replay served no request")
    if dc.LAUNCHES == before[1]:
        fail("the launcher's top-k replay never launched stage1_topk")
    row = rows[-1]
    return {"replay_n": row["n"], "replay_p50_ms": row["p50_ms"],
            "replay_p99_ms": row["p99_ms"], "replay_qps": row["qps"],
            "replay_batches": row["n_batches"],
            "replay_occupancy": row["mean_batch_occupancy"]}


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.core import sharded_softmax as sharded
    from repro_torch.kernels import build
    from repro_torch.kernels import ce_softmax as ce
    from repro_torch.kernels import topk_dc as dc

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s")
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"ptxas: {line.strip()}")

    kernels = kernel_phase(torch, ce, dc, sharded)
    exp, launches, e2e = serving_phase(torch, np, ce, dc, sharded)
    del exp
    torch.cuda.empty_cache()
    e2e.update(launcher_phase(torch, ce, dc))
    e2e["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    e2e["build_s"] = build_s

    rows = []
    for name, k in kernels.items():
        rows.append({**k, "launches": launches[name],
                     "kernel_ms": k["ms"], "max_err": k["max_abs_err"]})
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"end_to_end": e2e, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
