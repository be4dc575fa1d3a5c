"""Serving launcher of the port — a thin argparse shim over
``repro_torch.api.Experiment``, with the flags and validation of the JAX
package's ``repro.launch.serve``.

The paper deploys the trained class matrix as a retrieval index (§4.5 —
nearest class weight); ``Experiment.serve`` is that lookup. ``--replay
SECONDS`` switches onto the serving tier instead: single feature queries
from a bursty Zipfian synthetic trace go to a ``ServingEngine`` (request
coalescing into padded micro-batches, ``--max-wait-ms`` flush deadline,
optional ``--cache N`` LRU score cache), and the run reports p50/p95/p99
latency, QPS, batch occupancy and cache hit rate.

``--index ivf --topk K`` serves top-k through the IVF index (probe
``--nprobe`` k-means centroids, rerank only their member rows); the index
is fit before the first query, and before the trace under ``--replay``, so
the reported latencies do not include the fit.

``--system zoo`` is token serving for the zoo's decoders (``--arch``: any
arch id but the encoder-decoder whisper_tiny, which is an argparse error
without ``--topk`` or ``--replay``, as the JAX package's serve refuses
it; ``--reduced``): prefill ``--prompt-len`` tokens once, then
greedy decode ``--gen`` tokens through the KV / SSM cache and the
sharded-vocab argmax; it
prints the prefill and decode times and tok/s. With ``--topk K`` (and
``--index ivf [--nprobe N]``) or ``--replay`` it serves the zoo's feature
retrieval instead: d_model-wide queries classified against the model's
class matrix (the tied embedding), as in the JAX launcher.

It runs on the card (``--device cuda``, the default). Alone the paper
system is a ring of one; under ``torchrun --nproc-per-node N`` it serves
on one ring of N (``launch.mesh.launch_ring``; ``--share-cards`` for
processes that share a card): every member takes the same queries, holds
its row block of the class matrix and its own IVF index over it, the ring
merges the members' answers, and member 0 alone prints. ``--replay`` runs
the engine on every member over the same trace and virtual clock, which
cut the same micro-batches at the same trace times, so the members serve
each one together, in lockstep (the latencies printed are member 0's).
The zoo takes a (data, model) grid there (``launch_grid``). Every head
serves greedy (``--head``): the W-heads (full,
knn, selective, sampled) through the nearest class weight, which knn,
selective and sampled inherit from the full head, as in the JAX package
(knn builds its graph and selective its tables once when the experiment
starts); the sketch heads (mach, csoft) through their hashed-bucket
decode. ``--topk`` and ``--index ivf`` retrieve against the [V, D] class
matrix, which the sketch heads do not train: with them they raise, as in
the JAX package.

  PYTHONPATH=src python -m repro_torch.launch.serve --system paper \\
      --classes 1020250 --feat-dim 512 --topk 5 --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --system paper \\
      --classes 4096 --topk 5 --replay 1.0 --cache 512 --max-wait-ms 2
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --classes 4096 --head knn --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --classes 4096 --head csoft --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --classes 4096 --topk 5 --index ivf
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.serve --share-cards --classes 1020250 \\
      --feat-dim 512 --topk 5 --batch 64        # a ring of two, one card
  PYTHONPATH=src python -m repro_torch.launch.serve --system zoo \\
      --arch smollm_135m --prompt-len 2000 --gen 48 --batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --system zoo --arch smollm_135m --reduced --prompt-len 16 --gen 8 \\
      --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --system zoo \\
      --arch smollm_135m --topk 5 --index ivf --batch 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --system zoo --arch hymba_1_5b --reduced --prompt-len 40 --gen 8
"""
from __future__ import annotations

import argparse
import sys


def _say(*a, **kw) -> None:
    """``print`` on the group's member 0 (every process alone)."""
    from repro_torch import dist
    if dist.rank(dist.ALL) == 0:
        print(*a, **kw)


def _run_replay(exp, args, telemetry=None) -> int:
    """Trace-driven serving through the engine."""
    import numpy as np

    from repro_torch.serving import (ScoreCache, TraceConfig, VirtualClock,
                                     generate_trace, latency_stats,
                                     make_query_pool, replay_trace)

    tcfg = TraceConfig(duration=args.replay)
    times, qids = generate_trace(tcfg)
    pool = make_query_pool(args.classes, args.feat_dim, tcfg.pool,
                           device=exp.device)
    cache = ScoreCache(args.cache) if args.cache else None
    clock = VirtualClock()
    eng = exp.serving_engine(
        top_k=args.topk or None, max_batch=args.batch,
        max_wait_ms=args.max_wait_ms, cache=cache, clock=clock.now,
        index=_index(args), nprobe=args.nprobe or None, telemetry=telemetry)
    eng.warmup(pool[0])
    done = replay_trace(eng, clock, times, qids, pool)
    lat = latency_stats(done)
    st = eng.stats()
    span = max(r.t_done for r in done) - min(r.t_submit for r in done)
    if telemetry is not None:
        # the replay summary, one JSONL row under --metrics-out
        telemetry.log_metrics({
            "replay_s": args.replay, **lat, "qps": lat["n"] / max(span, 1e-9),
            "n_batches": st["n_batches"],
            "mean_batch_occupancy": st["mean_batch_occupancy"],
            "cache_hit_rate": st["cache_hit_rate"]})
    _say(f"[serve] replayed {lat['n']} requests over {args.replay:.1f}s "
         f"of trace ({args.head} head, top-{args.topk or 1}{_via(args)}, "
         f"{args.backend} on {exp.device}): "
         f"p50={lat['p50_ms']:.2f}ms p95={lat['p95_ms']:.2f}ms "
         f"p99={lat['p99_ms']:.2f}ms qps={lat['n'] / max(span, 1e-9):.1f}")
    _say(f"[serve] batches={st['n_batches']} "
         f"occupancy={st['mean_batch_occupancy']:.2f} "
         f"cache_hit_rate={st['cache_hit_rate']:.2f}")
    _say("[serve] first result ids:", np.atleast_1d(done[0].ids).tolist())
    return 0


def _index(args):
    return args.index if args.index != "none" else None


def _via(args) -> str:
    return f" via {args.index}" if args.index != "none" else ""


def _fit_index(exp, args) -> None:
    """Fit the IVF index up front, so no serve latency includes it."""
    idx = exp.ivf_index(nprobe=args.nprobe)
    parts = ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in idx.fit_s.items())
    _say(f"[serve] ivf index: {idx.n_clusters} clusters of cap {idx.cap}, "
         f"nprobe {idx.resolve_nprobe(args.nprobe or None)}; fit {parts}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--system", choices=["paper", "zoo"], default="paper")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda | cpu)")
    # zoo
    p.add_argument("--arch", default="smollm_135m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--n-model", type=int, default=None,
                   help="zoo under torchrun: the grid's model axis (default "
                        "min(4, processes), as the JAX ZooExperiment's)")
    p.add_argument("--share-cards", action="store_true",
                   help="under torchrun with more processes than cards: "
                        "take gloo, its collectives staged through host "
                        "memory")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    # paper
    p.add_argument("--classes", type=int, default=4096)
    p.add_argument("--feat-dim", type=int, default=64)
    p.add_argument("--head",
                   choices=["full", "knn", "selective", "mach", "sampled",
                            "csoft"],
                   default="full")
    p.add_argument("--topk", type=int, default=0,
                   help="return the k best classes per query with scores "
                        "(0 = greedy argmax)")
    p.add_argument("--index", choices=["none", "ivf"], default="none",
                   help="top-k serving index: 'ivf' probes nprobe k-means "
                        "centroids per class shard and reranks only their "
                        "member rows (sublinear in the class count)")
    p.add_argument("--nprobe", type=int, default=0,
                   help="--index ivf: centroids probed per shard "
                        "(0 = the index default, max(2, n_clusters/32))")
    p.add_argument("--backend", choices=["ref", "kernel"], default="kernel",
                   help="head hot-path compute backend: plain torch ops or "
                        "the hand-written CUDA kernels")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--replay", type=float, default=0.0, metavar="SECONDS",
                   help="replay a bursty Zipfian synthetic trace of this "
                        "many (virtual) seconds through the serving "
                        "engine instead of a one-shot batch")
    p.add_argument("--cache", type=int, default=0, metavar="N",
                   help="LRU hot-query score-cache capacity for --replay "
                        "(0 = no cache)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="coalescer flush deadline: max time a queued query "
                        "waits for batch-mates before a partial "
                        "micro-batch is cut")
    p.add_argument("--trace-out", default="", metavar="PATH",
                   help="write a Chrome-trace/Perfetto JSON of the serving "
                        "spans")
    p.add_argument("--metrics-out", default="", metavar="PATH",
                   help="append serving metrics as JSONL")
    args = p.parse_args(argv)

    if args.batch <= 0:
        p.error(f"--batch must be a positive query count, got {args.batch}")
    if args.topk < 0:
        p.error(f"--topk must be >= 0, got {args.topk}")
    if args.system == "paper" and args.topk > args.classes:
        p.error(f"--topk {args.topk} exceeds --classes {args.classes}: "
                f"retrieval cannot return more classes than exist")
    if args.index == "ivf" and not args.topk:
        p.error("--index ivf serves top-k retrieval; pass --topk K")
    if args.nprobe < 0:
        p.error(f"--nprobe must be >= 0, got {args.nprobe}")
    if args.nprobe and args.index != "ivf":
        p.error("--nprobe only applies with --index ivf")
    if args.cache < 0:
        p.error(f"--cache must be >= 0, got {args.cache}")
    if args.max_wait_ms < 0:
        p.error(f"--max-wait-ms must be >= 0, got {args.max_wait_ms}")
    if args.system == "zoo":
        from repro_torch.configs.base import (ARCH_IDS, get_model_config,
                                              normalize_arch_id)
        arch = normalize_arch_id(args.arch)
        if arch not in ARCH_IDS:
            p.error(f"unknown --arch {args.arch!r}; known: {ARCH_IDS}")
        if get_model_config(arch).family == "encdec" and not (
                args.topk or args.replay):
            p.error(f"--arch {args.arch}: token serving decodes decoder-only "
                    f"archs, as the JAX package's does; pass --topk (or "
                    f"--replay) for its feature retrieval")
    if args.system == "zoo" and not (args.topk or args.replay):
        if args.prompt_len <= 0 or args.gen <= 0:
            p.error(f"--prompt-len and --gen must be positive, got "
                    f"{args.prompt_len} and {args.gen}")

    from repro_torch.launch.mesh import launch_ring

    if args.system == "zoo":
        return _serve_zoo(args)
    with launch_ring(args.device, args.share_cards) as (n, backend):
        if n > 1:
            _say(f"[serve] ring of {n} over {backend}")
        return _traced(args, _serve_paper)


def _traced(args, serve) -> int:
    """``serve(args, tracer)`` with the run's ``Tracer``, whose metrics
    and trace files the group's member 0 writes."""
    from repro_torch import dist
    from repro_torch.telemetry import Tracer

    lead = dist.rank(dist.ALL) == 0
    tr = Tracer(metrics_path=(args.metrics_out if lead else "") or None)
    try:
        return serve(args, tr)
    finally:
        if args.trace_out and lead:
            tr.write_chrome_trace(args.trace_out)
            print(f"[telemetry] trace -> {args.trace_out}")
        tr.close()


def _serve_paper(args, tr) -> int:
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig

    def compute_ms() -> float:
        """Engine-measured compute wall-clock (ms) of this run's
        serve.compute spans."""
        return tr.span_stats("serve.compute")["total_s"] * 1e3

    exp = Experiment.from_config(
        system="paper", classes=args.classes, feat_dim=args.feat_dim,
        batch=args.batch, device=args.device,
        head=HeadConfig(softmax_impl=args.head, backend=args.backend))
    if args.index == "ivf":
        _fit_index(exp, args)
    if args.replay > 0:
        return _run_replay(exp, args, telemetry=tr)
    if args.topk:
        ids, scores = exp.serve(batch=args.batch, top_k=args.topk,
                                return_scores=True, index=_index(args),
                                nprobe=args.nprobe or None, telemetry=tr)
        _say(f"[serve] {args.head}-head top-{args.topk} retrieval over "
             f"{args.classes} classes ({args.backend}{_via(args)} on "
             f"{exp.device}): {ids.shape[0]} queries in "
             f"{compute_ms():.1f} ms")
        _say("[serve] first query ids:   ", ids[0].tolist())
        _say("[serve] first query scores:",
             [round(float(s), 3) for s in scores[0]])
        return 0
    preds = exp.serve(batch=args.batch, telemetry=tr)
    _say(f"[serve] {args.head}-head retrieval over {args.classes} classes "
         f"({args.backend} on {exp.device}): {preds.shape[0]} queries in "
         f"{compute_ms():.1f} ms")
    _say("[serve] first predictions:", preds[:8].tolist())
    return 0


def _serve_zoo(args) -> int:
    """The zoo's serving, under ``torchrun`` on a (data, model) grid of its
    processes (``launch.mesh.launch_grid``; ``--n-model``): token serving
    decodes each data shard's prompts, retrieval serves every query on
    every data shard. The tracer is made once the grid is joined, so that
    only its member 0 writes the metrics and the trace."""
    from repro_torch.launch.mesh import launch_grid

    with launch_grid(args.device, args.n_model,
                     args.share_cards) as (shape, backend):
        if shape != (1, 1):
            _say(f"[serve] grid (data, model) = {shape} over {backend}")
        return _traced(args, _serve_zoo_member)


def _serve_zoo_member(args, tr) -> int:
    from repro_torch.api import Experiment
    from repro_torch.configs.base import HeadConfig

    exp = Experiment.from_config(
        system="zoo", arch=args.arch, reduced=args.reduced, batch=args.batch,
        seq=args.prompt_len + args.gen, device=args.device,
        head=HeadConfig(softmax_impl=args.head, backend=args.backend))
    if args.topk or args.replay > 0:
        # feature retrieval against the model's class matrix: queries are
        # d_model embeddings over the (padded) vocab's classes
        args = argparse.Namespace(**{**vars(args),
                                     "classes": exp.model_cfg.vocab_size,
                                     "feat_dim": exp.model_cfg.d_model})
        if args.index == "ivf":
            _fit_index(exp, args)
        if args.replay > 0:
            return _run_replay(exp, args, telemetry=tr)
        ids, scores = exp.serve(batch=args.batch, top_k=args.topk,
                                return_scores=True, index=_index(args),
                                nprobe=args.nprobe or None, telemetry=tr)
        compute_ms = tr.span_stats("serve.compute")["total_s"] * 1e3
        _say(f"[serve] zoo {args.head}-head top-{args.topk} retrieval over "
             f"{args.classes} classes ({args.backend}{_via(args)} on "
             f"{exp.device}): {ids.shape[0]} queries in {compute_ms:.1f} ms")
        _say("[serve] first query ids:   ", ids[0].tolist())
        _say("[serve] first query scores:",
             [round(float(s), 3) for s in scores[0]])
        return 0
    gen = exp.serve(prompt_len=args.prompt_len, gen=args.gen,
                    batch=args.batch, telemetry=tr)
    prefill_ms = tr.span_stats("serve.prefill")["total_s"] * 1e3
    decode_s = tr.span_stats("serve.decode")["total_s"]
    _say(f"[serve] {exp.model_cfg.name} ({args.backend} on {exp.device}): "
         f"generated {gen.shape} tokens: prefill {prefill_ms:.1f} ms"
         f" + decode {decode_s * 1e3:.1f} ms "
         f"({args.batch * args.gen / max(decode_s, 1e-9):.1f} tok/s)")
    _say("[serve] first row:", gen[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
