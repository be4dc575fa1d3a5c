#!/usr/bin/env python3
"""Time ``dist_topk`` of a checkout on a CUDA card at the depths it runs at.

    python3 scripts/chip_dist_topk_depth.py ROOT

ROOT is the root of a checkout of this repository (its ``src/repro_torch``
is imported; the timer is this checkout's ``chip_smoke.cuda_ms``). Each
case is a graph build's slice: the first 16,896 of Nk unit rows in bf16
(random from seed 3) against all Nk, k' = 32, so every query meets itself
(a score of ~1):

- D 512 over the 1,020,250 class rows (the paper's knn graph build);
- D 2,048 and 3,072 over 151,936 rows (qwen3-moe's and a phi3-mini-wide
  table);
- D 8,192 over 65,536 rows (chameleon-34B's), where the checkout's
  ``MAX_DIM`` takes it.

For each: the kernel's mean time over CUDA events, its values on the first
1,024 rows against the plain version's (the fp32 product of the bf16 rows;
max abs error, and the largest drift of a self score), the share of equal
ids, and the bound (2 Nq Nk D operations at the 989 TFLOP/s dense bf16
rate). Prints one JSON line with the card's name and power limit.

To compare two commits on one card, unpack the other commit with ``git
archive`` into a git-ignored directory and run both in turns in one call:
``for t in OTHER . . OTHER; do python3 scripts/chip_dist_topk_depth.py $t;
done``. ``csrc/knn_dist_topk.cu`` sums every chunk by round-to-nearest
adds past ``PROMOTE_KC`` chunks of 64; a copy with ``PROMOTE_KC = 0``
times that body at every depth against the overlapped one.
"""
import json
import subprocess
import sys
from pathlib import Path

CASES = ((512, 1_020_250), (2048, 151_936), (3072, 151_936), (8192, 65_536))
NQ, CHECK, KPRIME = 16_896, 1_024, 32
BF16_OPS_PER_S = 989e12


def main(root: str) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, root + "/src")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_dist_topk_depth: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import knn_dist_topk as dk

    build.build_all()
    dev = torch.device("cuda")
    res = {"root": root, "cases": []}
    for d, nk in CASES:
        if d > dk.MAX_DIM:
            continue
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        k = torch.randn((nk, d), generator=g, device=dev)
        k = (k / k.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        q = k[:NQ].contiguous()
        vals, ids = dk.dist_topk(q[:CHECK].contiguous(), k, KPRIME)
        pv, pi = dk.dist_topk_plain(q[:CHECK], k, KPRIME)
        case = {
            "d": d, "nq": NQ, "nk": nk,
            "max_abs_err": float((vals - pv).abs().max()),
            "self_score_drift": float((vals[:, 0] - pv[:, 0]).abs().max()),
            "ids_equal_share": float((ids == pi).float().mean()),
            "ms": cs.cuda_ms(torch, lambda: dk.dist_topk(q, k, KPRIME), 5),
            "bound_ms": 2.0 * NQ * nk * d / BF16_OPS_PER_S * 1e3,
        }
        res["cases"].append(case)
        del k, q, vals, ids, pv, pi
        torch.cuda.empty_cache()
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return res


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")))
