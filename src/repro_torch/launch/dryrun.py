"""Dry run: one ring member's step built in shapes only, counted, and its
collectives held against the comm ledger: the port of the JAX package's
``launch/dryrun.py``.

Where the JAX package lowers and compiles each step for placeholder
devices and reads the compiled program, the port runs one member's step
on meta tensors (no storage, nothing computed) inside
``dist.simulated_ring(n_dev)`` (every collective an empty meta tensor of
its output's shape) under ``roofline.counter.WorkCounter`` (FLOPs,
bytes, collectives, and the peak of live storage bytes). A record has the
JAX record's layout: ``memory`` (the arguments' bytes, exact; the peak of
live bytes over the step), ``counted`` (FLOPs and bytes as counted, not
HLO), ``collectives``, and for the paper step the ``ledger`` and
``ledger_divergence``.

``lower_paper_one`` is the paper system's simulated 100M-class step
(Table 8): one hybrid train step at any class count, the head's row
block of W [classes / n_dev, D] on each member. ``lower_one`` is the zoo
on the port's ring (trunk replicated, vocab over the ring: the (1, n)
case of the JAX mesh) or, with ``mesh="16x16"`` / ``"2x16x16"``, member
(0, 0) of the production grid under ``make_parallel_config(fsdp=True)``
(``dist.simulated_grid``): every family's trunk tensor-, expert- and
FSDP-split as the JAX ``param_pspecs`` places it (the ssm mixer and the
hybrid block in their leaves' layouts, ``models.ssm``; the encoder-
decoder's attentions and MLPs over ``model``), the batch over ``data``
(and ``pod``) in ``auto_micro_batches`` micro-batches, as the live grid
splits them.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m --shape train_4k --n-dev 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch kimi_k2_1t_a32b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --paper-classes 100000000 --n-dev 256
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch import dist
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,
                                      LONG_CONTEXT_SKIP, HeadConfig,
                                      TrainConfig, for_shape,
                                      get_model_config, normalize_arch_id,
                                      pad_vocab, ring_parallel_config)
from repro_torch.optim import make_optimizer, tree_leaves
from repro_torch.roofline.counter import WorkCounter

META = torch.device("meta")
# the production grids (FSDP), by name; any other "DxM" / "PxDxM" is a
# (pod, data, model) grid under the host tests' policy
MESHES = {"ring": None, "16x16": (16, 16), "2x16x16": (2, 16, 16)}


def _grid_of(mesh: str):
    """(the (pod, data, model) sizes, its ParallelConfig at ``remat``) of
    a mesh name; (None, None) for the ring."""
    from repro_torch.launch.mesh import (make_host_parallel_config,
                                         make_parallel_config)
    if mesh == "ring":
        return None, None
    try:
        sizes = tuple(int(x) for x in mesh.split("x"))
    except ValueError:
        sizes = ()
    if not 2 <= len(sizes) <= 3 or min(sizes) < 1:
        raise ValueError(f"unknown mesh {mesh!r}: 'ring', or DxM / PxDxM "
                         f"({list(MESHES)} are the production grids)")
    grid = (1,) * (3 - len(sizes)) + sizes
    if mesh in MESHES:
        return grid, lambda remat: make_parallel_config(
            multi_pod=grid[0] > 1, remat=remat, fsdp=True)
    if grid[0] > 1:
        from repro_torch.configs.base import ParallelConfig
        return grid, lambda remat: ParallelConfig(
            mesh_shape=grid, axis_names=dist.AXES, remat=remat)
    return grid, lambda remat: make_host_parallel_config(grid[1], grid[2],
                                                         remat)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _tree_bytes(*trees) -> int:
    """Bytes of the distinct storages of the trees' tensors."""
    seen, n = set(), 0
    for t in tree_leaves(list(trees)):
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def _simulated(n_dev: int, grid: Optional[tuple] = None):
    """Member 0 of a simulated ring of ``n_dev``, or member (0, 0, 0) of
    a simulated grid of (pod, data, model) sizes ``grid``."""
    if grid is None:
        return dist.simulated_ring(n_dev, 0)
    n_pod, n_data, n_model = grid
    return dist.simulated_grid(n_data, n_model, n_pod)


def _count(fn, held, n_dev: int, grid: Optional[tuple] = None):
    """Run ``fn()`` as member 0 of a simulated ring of ``n_dev`` (or of
    ``grid``) under a counter that holds ``held``. Returns (counter,
    seconds)."""
    t0 = time.perf_counter()
    with _simulated(n_dev, grid), WorkCounter(track_memory=True) as wc:
        wc.hold(held)
        fn()
    return wc, time.perf_counter() - t0


def _memory(arg_bytes: int, wc: WorkCounter) -> dict:
    peak = max(wc.peak, arg_bytes)
    return {"argument_bytes": arg_bytes, "peak_bytes": peak,
            "temp_bytes": peak - arg_bytes}


def lower_paper_one(*, classes: int, head: str = "full",
                    backend: str = "ref", batch: int = 256,
                    feat_dim: int = 64, n_micro: int = 1,
                    n_dev: int = 1, knn_k: int = 16, trunk: str = "feats",
                    image_size: int = 224):
    """One paper-system hybrid train step of ring member 0 of ``n_dev`` at
    ``classes`` classes (10**8 for the simulated 100M run), in shapes
    only: W's row block, its momentum, the knn head's graph row at the
    post-refresh capacity ``classes * knn_k / n_dev`` and the global batch
    are meta tensors (module docstring). ``trunk="cnn"`` puts the reduced
    SKU ResNet in front (``image_size`` square images; its width is
    ``feat_dim``'s place), whose gradient exchange the ledger charges too.
    Returns the record with the analytic ``telemetry`` ledger and its
    divergence from the counted collectives, which must be none: the
    port's eager step runs every collective it calls, and no compiler
    merges one."""
    from repro_torch.api.experiment import paper_model_config
    from repro_torch.api.heads import make_head
    from repro_torch.models import resnet as resnet_lib
    from repro_torch.models.layers import MetaGenerator
    from repro_torch.telemetry import train_step_ledger
    from repro_torch.train import hybrid

    if head not in ("full", "knn"):
        raise ValueError(f"lower_paper_one models heads ('full', 'knn'), "
                         f"got {head!r}")
    if classes % n_dev:
        raise ValueError(f"classes={classes} must divide over {n_dev} "
                         f"devices")
    if batch % n_dev or (batch // n_dev) % n_micro:
        raise ValueError(f"batch={batch} (n_micro={n_micro}) must divide "
                         f"over {n_dev} devices")
    mcfg = paper_model_config(trunk, classes, feat_dim)
    feat_dim = mcfg.d_model
    hcfg = HeadConfig(softmax_impl=head, backend=backend, knn_k=knn_k,
                      knn_kprime=2 * knn_k, active_frac=0.1,
                      knn_pad_random=True)
    tcfg = TrainConfig(optimizer="sgd")
    h = make_head(mcfg, hcfg)
    v_loc = classes // n_dev
    w = _meta((v_loc, feat_dim))
    aux = ()
    if head == "knn":
        nnz_cap = classes * knn_k // n_dev
        aux = (_meta((classes + 1,), torch.int32),
               _meta((nnz_cap,), torch.int32), _meta((nnz_cap,), torch.int32))
    fe: dict = {}
    inputs = {"features": _meta((batch, feat_dim))}
    if trunk == "cnn":
        fe = {"trunk": resnet_lib.init_resnet(MetaGenerator(), mcfg)}
        inputs = {"images": _meta((batch, image_size, image_size, 3))}
    inputs["labels"] = _meta((batch,), torch.int32)
    opt_state = make_optimizer(tcfg).init((fe, w))
    state = hybrid.HybridState(fe, w, aux, opt_state, None, 0)
    n_fe = sum(t.numel() for t in tree_leaves(fe))
    step = hybrid.make_train_step(mcfg, hcfg, tcfg, n_micro=n_micro, head=h)
    arg_bytes = _tree_bytes(state, inputs)
    wc, secs = _count(lambda: step(state, inputs, 0.1), (state, inputs),
                      n_dev)
    out = wc.result()
    ledger = train_step_ledger(n_dev=n_dev, rows=batch, feat_dim=feat_dim,
                               head=head, backend=backend, n_micro=n_micro,
                               fe_param_count=n_fe)
    return {
        "arch": f"paper-{trunk}", "shape": f"B{batch}xD{feat_dim}",
        "mesh": f"{n_dev}", "mode": "train",
        "head": head, "backend": backend, "classes": classes,
        "n_micro": n_micro, "n_params": classes * feat_dim + n_fe,
        # the head's products a step, all cards: the scores and dW, and
        # df where a trunk takes it (the trunk's own work is not counted)
        "model_flops": 2.0 * batch * classes * feat_dim * (3 if n_fe else 2),
        "lower_s": round(secs, 3),
        "memory": _memory(arg_bytes, wc),
        **out,
        "ledger": ledger.per_kind(),
        "ledger_divergence": ledger.compare(out["collectives"], rtol=0.0),
    }


def _zoo_inputs(cfg, shape, batch: int):
    b, s = batch, shape.seq_len
    if shape.mode == "decode":
        return {"token": _meta((b, 1), torch.int32)}
    x = {"tokens": _meta((b, s), torch.int32)}
    if cfg.family == "encdec":
        x["frames"] = _meta((b, cfg.enc_seq, cfg.d_model),
                            getattr(torch, cfg.dtype))
    if shape.mode == "train":
        x["labels"] = _meta((b, s), torch.int32)
    return x


def lower_one(arch: str, shape_name: str, *, n_dev: int = 16,
              mesh: str = "ring", use_knn: bool = False,
              remat: str = "full", batch: int = 0, seq: int = 0,
              n_layers: int = 0, backend: str = "kernel",
              head_cfg: Optional[HeadConfig] = None):
    """One zoo step (train / prefill / decode, as the shape says) in shapes
    only. ``mesh="ring"``: member 0 of a ring of ``n_dev``, the ring's
    (1, n) mesh: the trunk replicated, every member running the whole
    batch, the vocab over the ring, one micro-batch. ``mesh="16x16"`` /
    ``"2x16x16"``: member (0, 0) of the production grid under
    ``make_parallel_config(remat=remat, fsdp=True)`` (any other ``"DxM"``:
    of that grid under ``make_host_parallel_config``; ``n_dev`` unused),
    its slices of the params, its data shard's rows in
    ``auto_micro_batches`` micro-batches, its KV heads and SSM blocks in
    the decode caches. ``batch`` and ``seq`` override the shape's,
    ``n_layers`` cuts the depth (0: the published one). The head is the
    JAX dry run's (full, raw logits; knn with ``use_knn``) unless
    ``head_cfg`` says otherwise."""
    import dataclasses

    from repro_torch.api.heads import HeadState, make_head
    from repro_torch.models import lm
    from repro_torch.train import gspmd

    grid, grid_par = _grid_of(mesh)
    if grid is not None:
        n_dev = grid[0] * grid[1] * grid[2]
    shape = INPUT_SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape,
                                    global_batch=batch or shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    cfg = for_shape(get_model_config(arch), shape)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_model = n_dev if grid is None else grid[2]
    cfg = pad_vocab(cfg, 128 * n_model // math.gcd(128, n_model))
    if grid is None:
        par, specs, micro = ring_parallel_config(n_dev, remat), None, 1
    else:
        lm.require_ported(cfg, grid=True)
        par = grid_par(remat)
        specs = gspmd.member_specs(cfg, par)
        micro = 0                  # auto_micro_batches, as the JAX run
    hcfg = head_cfg or HeadConfig(softmax_impl="knn" if use_knn else "full",
                                  backend=backend,
                                  cosine_scale=16.0 if use_knn else 0.0)
    use_knn = hcfg.softmax_impl == "knn"
    params = lm.abstract_model(cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    dt = getattr(torch, cfg.dtype)
    if shape.mode != "train":
        # serving runs on inference-dtype weights, not fp32 masters
        params = type(params)(**_cast(params, dt))
    n_shards = 1 if grid is None else grid[0] * grid[1]
    rows = shape.global_batch
    if rows % n_shards == 0:       # else replicated, as fit_spec leaves it
        rows //= n_shards
    inputs = _zoo_inputs(cfg, shape, rows)
    with _simulated(n_dev, grid):
        params = lm.cut(params, specs)
        if shape.mode == "train":
            head = make_head(cfg, hcfg)
            aux = ()
            if use_knn:
                v = cfg.vocab_size
                nnz = v * hcfg.knn_k // n_model
                aux = (_meta((v + 1,), torch.int32),
                       _meta((nnz,), torch.int32), _meta((nnz,), torch.int32))
            hs = HeadState((), aux)
            tcfg = TrainConfig(optimizer="sgd", micro_batch=micro)
            opt_state = make_optimizer(tcfg).init((params, ()))
            step = gspmd.make_head_train_step(cfg, hcfg, tcfg, shape,
                                              head=head, par=par, specs=specs)
            held = (params, aux, opt_state, inputs)

            def run():
                step(params, hs, opt_state, inputs, 0.1)
        elif shape.mode == "prefill":
            step = gspmd.make_prefill_step(cfg, shape, backend=backend,
                                           par=par, specs=specs)
            held = (params, inputs)

            def run():
                with torch.no_grad():
                    step(params, inputs)
        else:
            caches, slots, _ = lm.init_decode_state(
                cfg, rows, shape.seq_len, device=META, specs=specs)
            step = gspmd.make_serve_step(cfg, shape, backend=backend,
                                         specs=specs)
            held = (params, caches, slots, inputs)

            def run():
                with torch.no_grad():
                    step(params, caches, slots, inputs["token"])
        n_micro = (gspmd.auto_micro_batches(cfg, shape, par)
                   if shape.mode == "train" and not micro else 1)
    arg_bytes = _tree_bytes(held)
    wc, secs = _count(run, held, n_dev, grid)
    return {
        "arch": normalize_arch_id(arch), "shape": shape_name,
        "mesh": f"1x{n_dev}" if grid is None else mesh, "mode": shape.mode,
        "knn": use_knn, "remat": remat, "batch": shape.global_batch,
        "member_rows": rows, "n_micro": n_micro,
        "n_layers": cfg.n_layers, "n_params": int(n_params),
        "lower_s": round(secs, 3), "memory": _memory(arg_bytes, wc),
        **wc.result(),
    }


def _linear(a, b, n: int):
    """``a + (n - 1) * (b - a)`` over the numbers of two records' matching
    dicts (ints stay ints); other values are ``b``'s."""
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: _linear(a[k], b[k], n) if k in a else b[k] for k in b}
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and not isinstance(a, bool):
        return a + (n - 1) * (b - a)
    return b


def lower_deep(arch: str, shape_name: str, *, mesh: str, **kw) -> dict:
    """``lower_one`` at the arch's published depth, from two lowerings at 1
    and 2 layers: every layer of a decoder stack is the same, so the
    argument bytes, the peak, the counted FLOPs and bytes and the
    collectives are linear in the depth (``tests/test_torch_grid_specs.py``
    holds the extrapolation to a direct lowering exactly), and a meta step
    of the whole depth (61 layers of kimi-K2 in 8 micro-batches) takes
    tens of minutes of the host. The record is the deep one, with
    ``"extrapolated_from": [1, 2]`` and the two probes' ``lower_s``."""
    depth = get_model_config(arch).n_layers
    one = lower_one(arch, shape_name, mesh=mesh, n_layers=1, **kw)
    two = lower_one(arch, shape_name, mesh=mesh, n_layers=2, **kw)
    rec = {k: _linear(one[k], two[k], depth)
           for k in ("memory", "counted", "collectives", "terms_s",
                     "kernels")}
    return {**two, **rec, "n_layers": depth,
            "n_params": int(_linear(one["n_params"], two["n_params"],
                                    depth)),
            "extrapolated_from": [1, 2],
            "lower_s": round(one["lower_s"] + two["lower_s"], 3)}


def _cast(tree, dt):
    if isinstance(tree, dict):
        return {k: _cast(v, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dt) for v in tree]
    return tree.to(dt) if tree.dtype == torch.float32 else tree


def iter_combos(args):
    archs = ([normalize_arch_id(args.arch)] if args.arch else ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": ["16x16", "2x16x16"], "ring": ["ring"]}[args.mesh]
    for arch in archs:
        for shape_name in shapes:
            if shape_name == "long_500k" and arch in LONG_CONTEXT_SKIP:
                continue  # the enc-dec's 448-token decoder
            for mesh in meshes:
                yield arch, shape_name, mesh


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="")
    p.add_argument("--shape", default="", choices=[""] + list(INPUT_SHAPES))
    p.add_argument("--mesh", default="ring",
                   choices=["ring", "single", "multi", "both"],
                   help="ring: the port's (1, n-dev) ring; single / multi: "
                        "member (0, 0) of the 16x16 / 2x16x16 grid")
    p.add_argument("--n-dev", type=int, default=16)
    p.add_argument("--knn", action="store_true",
                   help="lower the KNN-softmax train step variant")
    p.add_argument("--remat", default="full", choices=["none", "full"])
    p.add_argument("--batch", type=int, default=0,
                   help="override the shape's global batch")
    p.add_argument("--paper-classes", type=int, default=0,
                   help="lower the paper system's hybrid step at this many "
                        "classes instead of the zoo")
    p.add_argument("--head", default="full", choices=["full", "knn"])
    p.add_argument("--backend", default="ref", choices=["ref", "kernel"])
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--n-micro", type=int, default=1)
    p.add_argument("--out", default="dryrun_results.jsonl")
    p.add_argument("--skip-done", action="store_true")
    args = p.parse_args(argv)

    if args.paper_classes:
        res = lower_paper_one(classes=args.paper_classes, head=args.head,
                              backend=args.backend,
                              batch=args.batch or 256,
                              feat_dim=args.feat_dim, n_micro=args.n_micro,
                              n_dev=args.n_dev)
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
        print(f"[dryrun] paper {args.paper_classes} classes x {args.n_dev}: "
              f"arguments {res['memory']['argument_bytes'] / 2**30:.3f} GiB, "
              f"peak {res['memory']['peak_bytes'] / 2**30:.3f} GiB a card; "
              f"ledger divergence {res['ledger_divergence'] or 'none'}")
        return 1 if res["ledger_divergence"] else 0

    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("knn", False)))
    n_ok = n_fail = 0
    with open(args.out, "a") as f:
        for arch, shape_name, mesh in iter_combos(args):
            mesh_name = f"1x{args.n_dev}" if mesh == "ring" else mesh
            if (arch, shape_name, mesh_name, args.knn) in done:
                continue
            tag = f"{arch} x {shape_name} x {mesh_name}" + \
                  (" [knn]" if args.knn else "")
            # a grid's step at the published depth: from 1 and 2 layers
            lower = lower_one if mesh == "ring" else lower_deep
            try:
                res = lower(arch, shape_name, n_dev=args.n_dev,
                            mesh=mesh, use_knn=args.knn,
                            remat=args.remat, batch=args.batch)
                n_ok += 1
                mem = res["memory"]
                print(f"[dryrun] OK   {tag}: {res['lower_s']:.1f}s "
                      f"flops={res['counted']['flops']:.3e} "
                      f"peak={mem['peak_bytes'] / 2**30:.2f} GiB/card")
            except Exception as e:  # noqa: BLE001 — record and continue
                res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "knn": args.knn, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                n_fail += 1
                print(f"[dryrun] FAIL {tag}: {type(e).__name__}: "
                      f"{str(e)[:200]}")
            f.write(json.dumps(res) + "\n")
            f.flush()
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
