#!/usr/bin/env python3
"""Find the deepest qwen3-moe-30B-A3B and chameleon-34B that train on one
CUDA card, at their published widths, with per-layer remat and the
in-place optimizer update.

    python3 scripts/chip_train_depth.py [ROOT]

ROOT (default: this script's checkout) is the root of a checkout of this
repository. Each attempt runs in a process of its own, so an attempt that
runs out of memory leaves nothing behind: ``chip_smoke._zoo_trainer``'s
experiment (16 x 512 tokens a step in one micro-batch, SGD at lr 0.5, the
kernel backend, seed 0) cut to the depth through ``FAM_LAYERS``, its
train step at ``remat="full"`` (``chip_smoke._with_remat``), ``fit(2)``:
the peak of ``torch.cuda.max_memory_allocated`` over the fit and the
second step's time. For each model, from the depth ``chip_smoke.py``
trains it at (which also runs with remat off), the depth climbs by 2, 4,
8, ... layers while the attempts fit, then the gap between the deepest
depth that fit and the shallowest that did not is halved until they
meet. Prints one JSON line per attempt and
a last line with the deepest depth that trained, the card's name and its
power limit.
"""
import json
import subprocess
import sys
from pathlib import Path

START = {"qwen3_moe_30b_a3b": 3, "chameleon_34b": 2}
CAP = {"qwen3_moe_30b_a3b": 24, "chameleon_34b": 16}
ATTEMPT_S = 240

ATTEMPT = r"""
import json, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import torch
import chip_smoke as cs
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all()
out = {{"arch": {arch!r}, "layers": {depth}, "remat": {remat!r}}}
# _zoo_trainer cuts the arch to its train depth in FAM_LAYERS
cs.FAM_LAYERS[{arch!r}] = (None, {depth})
try:
    exp = cs._zoo_trainer("kernel", arch={arch!r}, log_every=0,
                          train=TrainConfig(optimizer="sgd", micro_batch=1))
    if exp.model_cfg.n_layers != {depth}:
        raise RuntimeError(f"built {{exp.model_cfg.n_layers}} layers")
    exp.data_fn = lambda t, b: exp._synthetic_batch(0, b)
    cs._with_remat(exp, {remat!r})
    hist, ms, peak = cs._timed_fit(torch, exp, 2)
    out.update(ok=True, peak_gb=peak, step_ms=ms[-1],
               losses=[r["loss"] for r in hist])
except torch.cuda.OutOfMemoryError as e:
    out.update(ok=False, error=str(e).splitlines()[0][:160])
print("RESULT " + json.dumps(out))
"""


def attempt(root: Path, arch: str, depth: int, remat: str) -> dict:
    code = ATTEMPT.format(root=str(root), src=str(root / "src"), arch=arch,
                          depth=depth, remat=remat)
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=ATTEMPT_S)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "layers": depth, "remat": remat, "ok": False,
                "error": f"no result in {ATTEMPT_S} s"}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return {"arch": arch, "layers": depth, "remat": remat, "ok": False,
            "error": (out.stderr.strip().splitlines() or ["?"])[-1][:160]}


def main(argv) -> int:
    root = Path(argv[1] if len(argv) > 1 else
                Path(__file__).resolve().parents[1]).resolve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    deepest = {}
    for arch, start in START.items():
        print(json.dumps(attempt(root, arch, start, "none")), flush=True)
        runs = {}

        def fits(depth):
            runs[depth] = attempt(root, arch, depth, "full")
            print(json.dumps(runs[depth]), flush=True)
            return runs[depth]["ok"]

        # climb by 2, 4, 8, ... layers from the depth that fits, then
        # halve the gap between the deepest that fits and the shallowest
        # that does not
        good, bad, step = start, CAP[arch] + 1, 2
        if not fits(good):
            continue
        while good + step < bad and fits(good + step):
            good, step = good + step, step * 2
        if good + step < bad:
            bad = good + step
        while bad - good > 1:
            mid = (good + bad) // 2
            if fits(mid):
                good = mid
            else:
                bad = mid
        deepest[arch] = runs[good]
    print(json.dumps({"deepest": {a: r["layers"] for a, r in
                                  deepest.items()},
                      "peaks_gb": {a: r["peak_gb"] for a, r in
                                   deepest.items()}, "card": smi}))
    return 0 if len(deepest) == len(START) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
