"""Batched LM serving on the PyTorch/CUDA port, with the sharded-vocab head
(deploy path, §4.5 analog): prefill a batch of prompts, then greedy-decode
through the KV / SSM cache and the distributed argmax, at the settings of
``examples/serve_lm.py``. Works for any decoder-only zoo arch, at its
reduced smoke variant in fp32. It runs on the card unless ``--device cpu``
is given; under ``torchrun --nproc-per-node N`` on a (data, model) grid of
the N processes (``launch.mesh.launch_grid``).

  PYTHONPATH=src python examples/serve_lm_torch.py --arch mamba2_370m
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm_135m")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--gen", type=int, default=12)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda | cpu)")
    args = p.parse_args(argv)
    from repro_torch.launch.serve import main as serve_main
    return serve_main(["--system", "zoo", "--device", args.device,
                       "--arch", args.arch, "--reduced",
                       "--batch", str(args.batch),
                       "--prompt-len", str(args.prompt_len),
                       "--gen", str(args.gen)])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
