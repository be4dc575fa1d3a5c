"""Quickstart on the PyTorch/CUDA port: the whole paper system through the
``repro_torch`` ``Experiment`` API.

Trains a 4096-class extreme classifier with the KNN softmax head (periodic
exact-graph refresh) and FCCS batch growth, then evaluates AND serves with
the deploy-style nearest-class-weight lookup (§4.5), at the settings of
``examples/quickstart.py``. It runs on the card unless ``--device cpu`` is
given; alone it is a ring of one, and under ``torchrun --nproc-per-node N``
its N processes are one ring of N (``launch.mesh.launch_ring``), each
holding a row block of the class matrix. ``examples/quickstart.py`` runs
on 8 host devices, a ring of 8, whose head takes steps 8 times a ring of
one's at the same lr: its counterpart is this script on a ring of 8 (the
third command below); alone this script learns faster.

``HeadConfig.softmax_impl`` picks the output-layer strategy — any of the
six registered heads trains through the SAME trainer with no other change:

    softmax_impl="full"       exact distributed softmax (paper baseline)
    softmax_impl="knn"        KNN softmax, the paper's contribution (§3.2)
    softmax_impl="selective"  LSH active classes [Zhang et al., AAAI'18]
    softmax_impl="mach"       hashed bucket softmaxes [Medini et al.'19]
    softmax_impl="sampled"    logQ-corrected negative sampling [Jean'15]
    softmax_impl="csoft"      count-min sketch, min-decode

Swap ``system="paper"`` for ``system="zoo"`` (plus an ``arch=...``) to
train the same heads under the zoo trainer — the head registry is the
single seam between the two systems (docs/architecture.md).

Run me:         PYTHONPATH=src python examples/quickstart_torch.py
On the CPU:     PYTHONPATH=src python examples/quickstart_torch.py --device cpu
A ring of 8:    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
                    examples/quickstart_torch.py --device cpu
Pre-merge gate: bash scripts/smoke_torch.sh   (SMOKE_DEVICE=cpu on the CPU)
"""
import argparse
import sys

from repro_torch import dist
from repro_torch.api import Experiment
from repro_torch.configs.base import (DGCConfig, FCCSConfig, HeadConfig,
                                      TrainConfig)
from repro_torch.launch.mesh import launch_ring

# any registered head; see the table in the module docstring / docs/heads.md
SOFTMAX_IMPL = "knn"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu)")
    p.add_argument("--steps", type=int, default=150)
    args = p.parse_args(argv)
    n_classes, batch, steps = 4096, 128, args.steps

    with launch_ring(args.device):
        exp = Experiment.from_config(
            system="paper",
            classes=n_classes,
            feat_dim=64,
            batch=batch,
            head=HeadConfig(softmax_impl=SOFTMAX_IMPL, knn_k=16,
                            knn_kprime=32, active_frac=0.1,
                            rebuild_every=50, sampled_n=n_classes // 10,
                            csoft_b=256, csoft_r=4),
            train=TrainConfig(
                optimizer="sgd",
                fccs=FCCSConfig(eta0=5.0, t_warm=15, b0=batch, b_min=batch,
                                b_max=8 * batch, t_ini=40, t_final=150),
                dgc=DGCConfig(enabled=False)),
            log_every=25, device=args.device)

        exp.fit(steps, use_fccs_batch=True)
        acc = exp.evaluate(eval_batch=1024)
        preds = exp.serve(batch=64)
        if dist.rank() == 0:
            print(f"\nfinal deploy-style (nearest class weight) accuracy: "
                  f"{acc:.4f}")
            print(f"serve() returned {preds.shape[0]} retrieval ids; final "
                  f"batch = {exp.trainer.history[-1]['batch']}")
    return exp, acc


if __name__ == "__main__":
    main(sys.argv[1:])
