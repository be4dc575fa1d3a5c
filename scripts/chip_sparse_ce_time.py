#!/usr/bin/env python3
"""Time the sparse CE kernels of a checkout on a CUDA card.

    python3 scripts/chip_sparse_ce_time.py ROOT

ROOT is the root of a checkout of this repository (its ``src/repro_torch``
is imported; the problem and the timers are this checkout's
``chip_smoke``). The knn training shapes: B = 256 unit rows against
A = 102,025 active rows of a 1,020,250 x 512 unit shard (the rows' labels
first, 100 filler rows repeated), scale 16, the loss's cotangents, random
from seed 2 as ``chip_smoke.py``'s sparse phase. Each kernel is first
compared with its plain version (m and corr max abs error, z max relative
error; df and dW max abs error over max|plain|), then timed with CUDA
events (``chip_smoke.cuda_ms``), and one backward is profiled for its
kernels by name. Then the backward alone at the same shapes with the two
active sets of the selective and sampled heads (``padded``: a tenth of the
columns valid, the rest invalid columns of id 0, as selective pads its
active set; ``repeated``: every id drawn log-uniformly with replacement,
id 0 some 5,000 times, ``mask_hits``, as the sampled head's log_uniform
draw), each held to its plain version (dW's error over its max), both held to
the plain version in fp64, and timed. Prints one JSON line with the card's name.

To compare two commits on one card, unpack the other commit with ``git
archive`` into a git-ignored directory and run both in turns in one call:
``for t in OTHER . . OTHER; do python3 scripts/chip_sparse_ce_time.py $t;
done``.
"""
import json
import math
import subprocess
import sys
from pathlib import Path


def main(root: str) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, root + "/src")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_sparse_ce_time: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import sparse_ce as sp
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    b, a = cs.BTRAIN, max(8, int(cs.V * cs.ACTIVE_FRAC))
    f, w, ids, y = cs.sparse_problem(torch, g, b, cs.V, cs.D, a, n_dup=100,
                                     unit=True, dev=dev)
    bias = torch.zeros(a, device=dev)
    valid = torch.ones(a, dtype=torch.int32, device=dev)
    cols = (f, w, ids, ids, bias, valid, y)
    out = sp.sparse_ce_forward(*cols, scale=16.0)
    ref = sp.sparse_ce_forward_plain(*cols, 16.0, False)
    m, z, hit = out[0], out[1], out[4]
    gz = 1.0 / (b * z)
    gc = torch.full_like(z, -1.0 / b)
    df, dw = sp.sparse_ce_backward(*cols, m, gz, gc, hit, scale=16.0)
    pdf, pdw = sp.sparse_ce_backward_plain(*cols, m, gz, gc, ref[4], 16.0,
                                           False)
    rows = torch.zeros(cs.V, dtype=torch.bool, device=dev)
    rows[ids.long()] = True
    res = {
        "root": root,
        "m_corr_max_abs_err": max(float((out[0] - ref[0]).abs().max()),
                                  float((out[2] - ref[2]).abs().max())),
        "z_max_rel_err": float(((out[1] - ref[1]) / ref[1]).abs().max()),
        "hit_equal": bool(torch.equal(out[4], ref[4])),
        "df_err_of_max": float((df - pdf).abs().max() / pdf.abs().max()),
        "dw_err_of_max": float((dw[rows] - pdw[rows]).abs().max()
                               / pdw.abs().max()),
    }
    del pdf, pdw, ref
    res["forward_ms"] = cs.cuda_ms(
        torch, lambda: sp.sparse_ce_forward(*cols, scale=16.0), 30)
    bwd = lambda: sp.sparse_ce_backward(*cols, m, gz, gc, hit, scale=16.0)
    res["backward_ms"] = cs.cuda_ms(torch, bwd, 20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            bwd()
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            kernels[e.key[:60]] = (kernels.get(e.key[:60], 0.0)
                                   + e.self_device_time_total / 5e3)
    res["backward_kernels_ms"] = dict(sorted(kernels.items(),
                                             key=lambda k: -k[1]))
    del df, dw
    u = torch.rand((a,), generator=g, device=dev)
    drawn = (torch.exp(u * math.log(cs.V + 1.0)) - 1.0).to(
        torch.int32).clamp(0, cs.V - 1)
    tenth = (torch.arange(a, device=dev) < a // 10).to(torch.int32)
    for name, ids2, valid2, mask_hits in (
            ("padded", torch.where(tenth > 0, ids, 0), tenth, False),
            ("repeated", drawn, valid, True)):
        cols = (f, w, ids2, ids2, bias, valid2, y)
        m, z, _, _, hit = sp.sparse_ce_forward(*cols, scale=16.0,
                                               mask_hits=mask_hits)
        gz = 1.0 / (b * z)
        bwd = lambda: sp.sparse_ce_backward(*cols, m, gz, gc, hit,
                                            scale=16.0, mask_hits=mask_hits)
        dw = bwd()[1]
        pdw = sp.sparse_ce_backward_plain(*cols, m, gz, gc, hit, 16.0,
                                          mask_hits)[1]
        res[f"backward_{name}_dw_err_of_max"] = float(
            (dw - pdw).abs().max() / pdw.abs().max())
        # both against the same function in fp64: a run of equal ids sums
        # equal rows, whose fp32 sum drifts with the run's length
        d64 = [t.double() for t in (f, w, bias, m, gz, gc)]
        pdw64 = sp.sparse_ce_backward_plain(
            d64[0], d64[1], ids2, ids2, d64[2], valid2, y, *d64[3:], hit,
            16.0, mask_hits)[1]
        del d64
        top = float(pdw64.abs().max())
        res[f"backward_{name}_kernel_dw_err_vs_fp64"] = float(
            (dw - pdw64).abs().max()) / top
        res[f"backward_{name}_plain_dw_err_vs_fp64"] = float(
            (pdw - pdw64).abs().max()) / top
        del pdw64
        res[f"backward_{name}_most_repeated"] = int(
            torch.unique(ids2, return_counts=True)[1].max())
        del dw, pdw
        res[f"backward_{name}_ms"] = cs.cuda_ms(torch, bwd, 10)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return res


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")))
