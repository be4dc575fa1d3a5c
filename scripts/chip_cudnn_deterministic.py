#!/usr/bin/env python3
"""What cuDNN's deterministic algorithms would cost the cnn step on a card.

    python3 scripts/chip_cudnn_deterministic.py ROOT

ROOT is the root of a checkout of this repository (its ``src/repro_torch``
is imported; the experiment and the timers are this checkout's
``chip_smoke``). ResNet-50 + DGC + the full head at 1,020,250 classes, as
``chip_smoke.py``'s cnn and checkpoint phases build it, runs ``fit(6)``;
then the n_micro = 1 step on one micro-batch of 128 images is timed on the
host clock (``chip_smoke.host_ms``, median of 3 after a warm-up) with
cuDNN's default algorithms and with ``cudnn.deterministic``, in turns
(default, deterministic, deterministic, default), and one micro-step's
gradients are computed twice under the deterministic algorithms and
compared (``chip_smoke._micro_step_diff``). A measurement only: the
training path keeps cuDNN's defaults. Prints one JSON line with the
card's name and power limit.
"""
import json
import subprocess
import sys
from pathlib import Path


def main(root: str) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, root + "/src")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_cudnn_deterministic: needs a CUDA card")
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.train.trainer import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    exp = cs._cnn_experiment("kernel")
    exp.fit(cs.CKPT_TOTAL, use_fccs_batch=True)
    step = exp.trainer._get_step(1)
    inputs = to_device(exp.data_fn(10**5 + 1, cs.RES_MICRO), exp.device)

    def one():
        exp.trainer.state = step(exp.trainer.state, inputs, 0.4)[0]

    cudnn = torch.backends.cudnn
    ms = {False: [], True: []}
    for det in (False, True, True, False):
        cudnn.deterministic = det
        ms[det].append(cs.host_ms(torch, one, 3))
    cudnn.deterministic = True
    diff = cs._micro_step_diff(torch, exp)
    cudnn.deterministic = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"card": card, "root": root, "step_ms": ms[False],
            "step_ms_deterministic": ms[True],
            "deterministic_micro_step": diff}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")))
