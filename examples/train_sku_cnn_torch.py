"""End-to-end run on the PyTorch/CUDA port: the paper's own setting — a
CNN feature extractor (ResNet-family trunk, GroupNorm adaptation) + an
extreme-classification head — trained for a few hundred steps on the
synthetic SKU image stream with the hybrid-parallel system, at the
settings of ``examples/train_sku_cnn.py``. This exercises the FULL paper
pipeline: data-parallel conv trunk, all-gathered features, model-parallel
fc, KNN softmax, DGC on the trunk gradients. The head and DGC's threshold
run the port's kernels (``backend="kernel"``, the port's default for the
head).

It runs on the card unless ``--device cpu`` is given; alone it is a ring
of one, under ``torchrun --nproc-per-node N`` a ring of N
(``launch.mesh.launch_ring``). ``examples/train_sku_cnn.py`` runs on 8
host devices, a ring of 8: its counterpart is this script under
``torchrun --standalone --nproc-per-node 8 ... --device cpu``.

  PYTHONPATH=src python examples/train_sku_cnn_torch.py [--steps 200]
  PYTHONPATH=src python examples/train_sku_cnn_torch.py --device cpu \\
      --steps 12 --classes 256 --batch 32
"""
import argparse
import dataclasses
import sys

from repro_torch import dist
from repro_torch.configs import sku100m_resnet
from repro_torch.configs.base import DGCConfig, HeadConfig, TrainConfig
from repro_torch.data.synthetic import sku_image_batch
from repro_torch.launch.mesh import launch_ring
from repro_torch.train.trainer import PaperTrainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--classes", type=int, default=512)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda | cpu)")
    args = p.parse_args(argv)

    with launch_ring(args.device):
        model = sku100m_resnet.reduced(args.classes)
        model = dataclasses.replace(model, dtype="float32")
        head = HeadConfig(softmax_impl="knn", knn_k=16, knn_kprime=32,
                          active_frac=0.2, rebuild_every=60)
        train = TrainConfig(optimizer="sgd", momentum=0.9,
                            dgc=DGCConfig(enabled=True, sparsity=0.99,
                                          chunk=2048,
                                          backend=head.backend))

        trainer = PaperTrainer(
            model, head, train,
            lambda t, b: sku_image_batch(t, b, args.classes,
                                         device=args.device),
            hw_batch=args.batch, device=args.device, log_every=20,
            lr_fn=lambda t: 0.5 * min(1.0, (t + 1) / 20))
        trainer.run(args.steps, use_fccs_batch=False)
        acc = trainer.evaluate(sku_image_batch(10**6, 256, args.classes,
                                               device=args.device))
        if dist.rank() == 0:
            print(f"\nfinal accuracy (CNN trunk + KNN softmax + DGC): "
                  f"{acc:.4f}")
    return trainer, acc


if __name__ == "__main__":
    main(sys.argv[1:])
