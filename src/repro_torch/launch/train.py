"""Training launcher of the port: a thin argparse shim over
``repro_torch.api.Experiment``, with the flags of the JAX package's
``repro.launch.train`` for the paper system.

``--system paper`` trains the hybrid-parallel paper system (feature
replicas + class-row shards) with any of the six softmax heads
(``--head full|knn|selective|mach|sampled|csoft``, ``--knn`` an alias of
``--head knn``) at the JAX launcher's settings: k=16, k'=32 and 10% active
classes for knn and selective, the graph and the LSH tables rebuilt every
100 steps, ``sampled_n = max(64, classes // 4)``, and the config's
defaults for the rest. It runs the FCCS learning rate and, with
``--fccs``, its batch growth through micro-batch accumulation, in
§3.3.1's pipelined schedule, on the card (``--device cuda``, the
default). Alone it is a ring of one; under ``torchrun --nproc-per-node
N`` the N processes are one ring of N (``launch.mesh.launch_ring``: NCCL
with a card a process, gloo on the CPU, and gloo with the collectives
staged through host memory with ``--share-cards``, for processes that
share a card): every member draws the same global batch, member 0 writes
the checkpoints and alone prints the result lines and writes
``--metrics-out`` / ``--trace-out``.
``--trunk cnn`` trains the reduced SKU ResNet on 32 x 32 synthetic images
(its width is the config's; ``--feat-dim`` is not read), and ``--dgc``
sparsifies the feature extractor's gradients as the JAX launcher does
(sparsity 0.99, chunks of 2,048, the threshold on ``--backend``'s top-k).
``--ckpt-dir D --ckpt-every N [--ckpt-keep K]`` writes full-state
checkpoints; ``--resume`` restores the latest one under ``--ckpt-dir``
(``--resume CKPT`` names the directory, or a file in it, and implies
``--ckpt-dir``) and runs only the rest of ``--steps``, which is then the
TOTAL; ``--resume-reshard`` (implying ``--resume``) also takes a
checkpoint written on a ring of another size.

``--system zoo`` trains the zoo's ``--arch`` (any arch id: the dense
smollm_135m, qwen3_1_7b, gemma_2b, phi3_mini_3_8b, the vlm chameleon_34b,
the moe qwen3_moe_30b_a3b and kimi_k2_1t_a32b, the ssm mamba2_370m, the
hybrid hymba_1_5b, the encdec whisper_tiny with its stubbed frames;
``--reduced``: its smoke variant, in fp32) on ``--batch`` x ``--seq``
tokens of the synthetic LM stream a step, with any of the six
heads (the JAX launcher's head settings: k=16, k'=32, 10% active, rebuilt
every 100 steps), at ``--lr`` with ``--optimizer``, and prints ``[zoo]
final next-token accuracy``. ``--ckpt-*`` and ``--resume*`` work there as
they do for the paper system.

  PYTHONPATH=src python -m repro_torch.launch.train --system paper \\
      --classes 1020250 --feat-dim 512 --batch 256 --steps 4 --fccs
  PYTHONPATH=src python -m repro_torch.launch.train --head knn \\
      --classes 1020250 --feat-dim 512 --batch 256 --steps 4 --fccs
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --classes 512 --feat-dim 32 --steps 8 --batch 32 --fccs
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --head mach --lr 0.3 --classes 512 --feat-dim 32 --steps 8 --batch 32
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --trunk cnn --dgc --classes 512 --steps 4 --batch 16 --fccs
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --ckpt-dir ck --ckpt-every 2 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --ckpt-dir ck --resume --steps 6      # restores t=4, runs steps 4, 5
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --device cpu --classes 512 \\
      --feat-dim 32 --steps 8 --batch 32 --fccs      # a ring of two
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train --share-cards --classes 1020250 \\
      --feat-dim 512 --batch 256 --steps 4 --fccs    # two on one card
  PYTHONPATH=src python -m repro_torch.launch.train --system zoo \\
      --arch smollm_135m --batch 16 --seq 512 --steps 2 --lr 0.5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --system zoo --reduced --head knn --batch 4 --seq 16 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --system zoo --arch mamba2_370m --reduced --batch 4 --seq 16 \\
      --lr 0.5 --ckpt-dir zck --ckpt-every 2 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --system zoo --arch mamba2_370m --reduced --batch 4 --seq 16 \\
      --lr 0.5 --ckpt-dir zck --resume --steps 6    # runs steps 4, 5
"""
from __future__ import annotations

import argparse
import math
import os
import sys



def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--system", choices=["paper", "zoo"], default="paper")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda | cpu)")
    p.add_argument("--classes", type=int, default=4096)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--head",
                   choices=["full", "knn", "selective", "mach", "sampled",
                            "csoft"],
                   default="full", help="softmax head strategy")
    p.add_argument("--backend", choices=["ref", "kernel"], default="kernel",
                   help="head hot-path compute backend: plain torch ops or "
                        "the hand-written CUDA kernels")
    p.add_argument("--knn", action="store_true",
                   help="back-compat alias for --head knn")
    p.add_argument("--dgc", action="store_true")
    p.add_argument("--fccs", action="store_true",
                   help="FCCS batch growth (micro-batch accumulation)")
    p.add_argument("--trunk", choices=["feats", "cnn"], default="feats")
    # zoo system
    p.add_argument("--arch", default="smollm_135m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--n-model", type=int, default=None,
                   help="under torchrun: the grid's model axis (default "
                        "min(4, processes), as the JAX ZooExperiment's)")
    p.add_argument("--share-cards", action="store_true",
                   help="under torchrun with more processes than cards: "
                        "take gloo, its collectives staged through host "
                        "memory")
    # shared
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=2.0)
    p.add_argument("--optimizer", choices=["sgd", "lars", "adam"],
                   default="sgd")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=None,
                   help="full-state snapshot cadence in steps (default 50 "
                        "with --ckpt-dir)")
    p.add_argument("--ckpt-keep", type=int, default=None,
                   help="retain only the N newest checkpoints "
                        "(>= 1; omit to keep all)")
    p.add_argument("--resume", nargs="?", const=True, default=False,
                   metavar="CKPT",
                   help="restore the latest checkpoint and run only the "
                        "remaining steps (--steps is the TOTAL). With no "
                        "value, restores from --ckpt-dir; a value names a "
                        "checkpoint directory (or a .msgpack.zst file inside "
                        "one) and implies --ckpt-dir")
    p.add_argument("--resume-reshard", action="store_true",
                   help="allow --resume from a checkpoint written on a ring "
                        "of another size; implies --resume")
    p.add_argument("--trace-out", default="", metavar="PATH",
                   help="write a Chrome-trace/Perfetto JSON of the run's "
                        "telemetry spans")
    p.add_argument("--metrics-out", default="", metavar="PATH",
                   help="append per-step train metrics as JSONL")
    args = p.parse_args(argv)

    if args.steps <= 0:
        p.error(f"--steps must be positive, got {args.steps}")
    if args.batch <= 0:
        p.error(f"--batch must be positive, got {args.batch}")
    if args.system == "zoo":
        from repro_torch.configs.base import ARCH_IDS, normalize_arch_id
        if normalize_arch_id(args.arch) not in ARCH_IDS:
            p.error(f"unknown --arch {args.arch!r}; known: {ARCH_IDS}")
    if args.seq <= 0:
        p.error(f"--seq must be positive, got {args.seq}")
    # --knn is a back-compat alias; an explicit non-default --head wins
    args.head = "knn" if (args.knn and args.head == "full") else args.head
    if args.resume_reshard and not args.resume:
        args.resume = True
    if isinstance(args.resume, str):
        # --resume CKPT names the checkpoint to restore from: the directory
        # or one of its .msgpack.zst files
        path = args.resume
        if path.endswith(".msgpack.zst"):
            path = os.path.dirname(path) or "."
        if args.ckpt_dir and args.ckpt_dir != path:
            p.error(f"--resume {args.resume} conflicts with "
                    f"--ckpt-dir {args.ckpt_dir}")
        args.ckpt_dir = path
        args.resume = True
    if args.resume and not args.ckpt_dir:
        p.error("--resume requires --ckpt-dir (or --resume CKPT)")
    if args.ckpt_keep is not None and args.ckpt_keep <= 0:
        p.error("--ckpt-keep must be >= 1 (omit the flag to keep all)")
    if args.ckpt_every is None:
        args.ckpt_every = 50
    if args.ckpt_every < 0:
        p.error("--ckpt-every must be >= 0")
    return args


def main(argv=None):
    args = parse_args(argv)

    from repro_torch.launch.mesh import launch_ring

    if args.system == "zoo":
        return _train_zoo(args)
    with launch_ring(args.device, args.share_cards) as (n, backend):
        return _train_paper(args, n, backend)


def _tracer(args, *, lead: bool):
    """The run's ``Tracer`` when ``--trace-out`` or ``--metrics-out`` asks
    for one (else None), writing ``--metrics-out`` only where ``lead``."""
    from repro_torch.telemetry import Tracer
    if not (args.trace_out or args.metrics_out):
        return None
    return Tracer(metrics_path=(args.metrics_out if lead else "") or None)


def _train_paper(args, n: int, backend) -> int:
    """The paper system on this member of a ring of ``n``
    (``launch.mesh.launch_ring``); member 0 prints."""
    from repro_torch import dist
    from repro_torch.api import Experiment
    from repro_torch.configs.base import (DGCConfig, FCCSConfig, HeadConfig,
                                          TrainConfig)

    lead = dist.rank() == 0
    say = print if lead else (lambda *a, **k: None)
    if n > 1:
        say(f"[train] ring of {n} over {backend}")
    telemetry = _tracer(args, lead=lead)
    try:
        # sampled_n below the class count, so that the estimator (a
        # partial draw + the logQ correction) is what runs, as in the JAX
        # launcher
        hcfg = HeadConfig(softmax_impl=args.head, backend=args.backend,
                          knn_k=16, knn_kprime=32, active_frac=0.1,
                          rebuild_every=100,
                          sampled_n=max(64, args.classes // 4))
        fcfg = FCCSConfig(eta0=args.lr, t_warm=max(1, args.steps // 10),
                          b0=args.batch, b_min=args.batch,
                          b_max=args.batch * 8,
                          t_ini=args.steps // 4, t_final=args.steps)
        tcfg = TrainConfig(optimizer=args.optimizer, fccs=fcfg,
                           dgc=DGCConfig(enabled=args.dgc, sparsity=0.99,
                                         chunk=2048, backend=args.backend))
        exp = Experiment.from_config(
            system="paper", trunk=args.trunk, classes=args.classes,
            feat_dim=args.feat_dim, batch=args.batch, head=hcfg, train=tcfg,
            ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
            ckpt_keep=args.ckpt_keep or 0, device=args.device)
        resume = ("reshard" if args.resume_reshard
                  else bool(args.resume))
        hist = exp.fit(args.steps, use_fccs_batch=args.fccs,
                       resume=resume, telemetry=telemetry)
        if resume:
            start = hist[0]["step"] if hist else args.steps
            say(f"[train] resumed at t={start}: {len(hist)} steps to "
                f"{args.steps}")
        if not hist:
            say(f"[train] nothing to run: the checkpoint is at step "
                f"{args.steps}")
            return 0
        acc = exp.evaluate(eval_batch=args.batch * 4)
        if not (math.isfinite(hist[-1]["loss"]) and math.isfinite(acc)):
            print(f"[train] non-finite result: loss {hist[-1]['loss']}, "
                  f"accuracy {acc}", file=sys.stderr)
            return 1
        say(f"[train] final eval accuracy: {acc:.4f}")
        if lead:
            _finish_telemetry(args, telemetry)
        return 0
    finally:
        if telemetry is not None:
            telemetry.close()


def _finish_telemetry(args, telemetry) -> None:
    if telemetry is None:
        return
    telemetry.record_peak_memory()
    if args.trace_out:
        telemetry.write_chrome_trace(args.trace_out)
        st = telemetry.span_stats("train.step")
        print(f"[telemetry] {st['count']} train.step spans "
              f"({st['total_s']:.2f}s) -> {args.trace_out}")
    if args.metrics_out:
        print(f"[telemetry] metrics -> {args.metrics_out}")


def _train_zoo(args) -> int:
    """The zoo trainer on ``--arch`` (``--reduced``: its smoke variant in
    fp32) over ``--batch`` x ``--seq`` tokens a step, with the JAX
    launcher's head settings; under ``torchrun`` on a (data, model) grid
    of its processes (``launch.mesh.launch_grid``; ``--n-model``)."""
    from repro_torch import dist
    from repro_torch.launch.mesh import launch_grid

    with launch_grid(args.device, args.n_model,
                     args.share_cards) as (shape, backend):
        # the group's member 0 alone prints and writes --metrics-out and
        # --trace-out
        lead = dist.rank(dist.ALL) == 0
        if shape != (1, 1) and lead:
            print(f"[zoo] grid (data, model) = {shape} over {backend}")
        telemetry = _tracer(args, lead=lead)
        try:
            return _train_zoo_member(args, telemetry, lead)
        finally:
            if telemetry is not None:
                telemetry.close()


def _train_zoo_member(args, telemetry, lead: bool) -> int:
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig, TrainConfig

    say = print if lead else (lambda *a, **k: None)
    hcfg = HeadConfig(softmax_impl=args.head, backend=args.backend,
                      knn_k=16, knn_kprime=32, active_frac=0.1,
                      rebuild_every=100)
    exp = Experiment.from_config(
        system="zoo", arch=args.arch, reduced=args.reduced,
        batch=args.batch, seq=args.seq, head=hcfg,
        train=TrainConfig(optimizer=args.optimizer),
        ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
        ckpt_keep=args.ckpt_keep or 0, device=args.device)
    resume = "reshard" if args.resume_reshard else bool(args.resume)
    hist = exp.fit(args.steps, lr=args.lr, resume=resume,
                   telemetry=telemetry)
    if resume:
        start = hist[0]["step"] if hist else args.steps
        say(f"[zoo] resumed at t={start}: {len(hist)} steps to "
            f"{args.steps}")
    if not hist:
        say(f"[zoo] nothing to run: the checkpoint is at step "
            f"{args.steps}")
        return 0
    acc = exp.evaluate()
    if not (math.isfinite(hist[-1]["loss"]) and math.isfinite(acc)):
        print(f"[zoo] non-finite result: loss {hist[-1]['loss']}, "
              f"accuracy {acc}", file=sys.stderr)
        return 1
    say(f"[zoo] final next-token accuracy: {acc:.4f}")
    if lead:
        _finish_telemetry(args, telemetry)
    return 0


if __name__ == "__main__":
    sys.exit(main())
