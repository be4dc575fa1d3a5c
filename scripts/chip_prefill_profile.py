#!/usr/bin/env python3
"""Profile one zoo prefill of a checkout on a CUDA card.

    python3 scripts/chip_prefill_profile.py ROOT

ROOT is the root of a checkout of this repository (its ``src/repro_torch``
is imported; the profile itself is this checkout's ``chip_smoke``). SmolLM-
135M at full width, random weights from seed 0, 8 prompts of 2,000 tokens
on the ``kernel`` backend, as ``chip_smoke.py``'s zoo phase. One profiled
prefill (``chip_smoke.profile_ms``) gives the device time, the copies and
casts in it and the costliest kernels, then five synchronised prefills the
host wall time (``chip_smoke.host_ms``, median). Prints one JSON line.

To compare two commits on one card, unpack the other commit with ``git
archive`` into a git-ignored directory and run both in turns in one call:
``for t in OTHER . . OTHER; do python3 scripts/chip_prefill_profile.py $t;
done``.
"""
import json
import sys
from pathlib import Path


def main(root: str) -> dict:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, root + "/src")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_prefill_profile: needs a CUDA card")
    import chip_smoke
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig, InputShape
    from repro_torch.data import synthetic
    from repro_torch.kernels import build
    from repro_torch.train import gspmd

    build.build_all()
    exp = Experiment.from_config(system="zoo", arch="smollm_135m", batch=8,
                                 seq=2048, seed=0, device="cuda",
                                 head=HeadConfig(backend="kernel"))
    cfg = exp.model_cfg
    prompts = synthetic.lm_batch(0, 8, 2000, cfg.vocab_size,
                                 device="cuda")["tokens"]
    prefill = gspmd.make_prefill_step(
        cfg, InputShape("serve-decode", 2048, 8, "decode"), backend="kernel")

    def run():
        prefill(exp.params, {"tokens": prompts})

    with torch.no_grad():
        for _ in range(2):
            run()
        prof = chip_smoke.profile_ms(torch, run)
        wall = chip_smoke.host_ms(torch, run, 5)
    flash = sum(ms for name, ms in prof["top_kernels_ms"].items()
                if "flash" in name)
    return {"tree": root, "card": torch.cuda.get_device_name(0),
            "busy_ms": prof["device_busy_ms"], "flash_ms": flash,
            "copy_ms": prof["copy_ms"], "cast_ms": prof["cast_ms"],
            "profiled_wall_ms": prof["wall_ms"], "wall_ms": wall}


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else ".")))
