#!/usr/bin/env python
"""The Python legs of ``scripts/smoke_torch.sh``, the port's pre-merge
gate: each is the counterpart of an inline script of ``scripts/smoke.sh``.

The ring legs run in every member of a ring that ``torchrun`` started
(``launch.mesh.launch_ring``; alone, a ring of one); member 0 alone
prints and writes. On a card shared by the ring's processes they take
gloo, the collectives staged through host memory (``share_cards``).

  resilience ROOT      kill-and-recover of the full and knn heads, 8 steps
                       killed at 4, bitwise against the uninterrupted run
  elastic-save ROOT    4 steps of the full and MACH heads with checkpoints,
                       and the serve references (top-5 ids and scores;
                       greedy ids)
  elastic-restore ROOT the checkpoints restored with ``reshard=True`` on
                       this ring, serving the references' answers
  ivf                  the IVF index of the full and knn heads on both
                       backends over clustered prototypes placed into each
                       member's shard: recall@5 against the exact scan at
                       the default nprobe, the exact ids at nprobe = C
  check-replay FILE..  (no ring) each ``launch.serve --replay
                       --metrics-out`` row: p99 > 0, the cache hit rate in
                       [0, 1] and > 0 where a cache was given
  check-telemetry DIR  (no ring) the train launcher's trace and metrics
                       of a 5-step run

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      scripts/smoke_torch_legs.py --device cpu resilience /tmp/ck
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _say(*a) -> None:
    from repro_torch import dist
    if dist.rank() == 0:
        print(*a, flush=True)


def _head(head: str, **kw):
    from repro_torch.configs.base import HeadConfig
    return HeadConfig(softmax_impl=head, knn_k=8, knn_kprime=16,
                      rebuild_every=5, **kw)


def resilience(root: str, device: str) -> None:
    from repro_torch.api import Experiment
    from repro_torch.resilience import kill_and_recover

    for head in ("full", "knn"):
        def make_exp(ckpt_dir, head=head):
            return Experiment.from_config(
                system="paper", classes=256, feat_dim=32, batch=16,
                head=_head(head), ckpt_dir=ckpt_dir, ckpt_every=4,
                log_every=0, device=device)
        rep = kill_and_recover(
            make_exp, total_steps=8, kill_at=4, ckpt_dir=f"{root}/{head}",
            head=head, fit_kw={"use_fccs_batch": False})
        _say(rep.summary())
        assert rep.ok, rep.summary()


def _elastic_exp(head: str, root: str, device: str):
    from repro_torch.api import Experiment
    return Experiment.from_config(
        system="paper", classes=256, feat_dim=32, batch=16,
        head=_head(head, mach_b=64, mach_r=2), ckpt_dir=f"{root}/{head}",
        ckpt_every=4, log_every=0, device=device)


def _elastic_serve(exp, head: str):
    """The full head's top-5 (ids, scores), the sketch head's greedy ids
    (no [V, D] matrix to take a top-k of), on the stream's batch 10^6."""
    x = exp.data_fn(10**6, 16)
    if head == "full":
        return exp.serve(x, top_k=5, return_scores=True)
    return exp.serve(x), np.zeros(())


def elastic_save(root: str, device: str) -> None:
    from repro_torch import dist
    for head in ("full", "mach"):
        exp = _elastic_exp(head, root, device)
        exp.fit(4, use_fccs_batch=False)
        ids, sc = _elastic_serve(exp, head)
        if dist.rank() == 0:
            np.savez(f"{root}/{head}_ref.npz", ids=np.asarray(ids),
                     sc=np.asarray(sc))
    _say(f"elastic: {dist.world_size()}-member source checkpoints + serve "
         f"references written")


def elastic_restore(root: str, device: str) -> None:
    from repro_torch import dist
    n = dist.world_size()
    for head in ("full", "mach"):
        exp = _elastic_exp(head, root, device)
        assert exp.restore(reshard=True) == 4
        ids, sc = _elastic_serve(exp, head)
        ref = np.load(f"{root}/{head}_ref.npz")
        if head == "full":      # dense ids AND scores bitwise across rings
            np.testing.assert_array_equal(np.asarray(sc), ref["sc"])
        np.testing.assert_array_equal(np.asarray(ids), ref["ids"])
        _say(f"elastic -> {n} / {head}: restored step 4, serve parity OK "
             f"(bytes_moved={exp.trainer.last_reshard['bytes_moved']:.0f})")


def ivf(device: str) -> None:
    import torch

    from repro_torch import dist
    from repro_torch.api import Experiment

    classes, d, mb, k = 1024, 16, 16, 5
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((classes // 64, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    protos = centers[rng.integers(0, len(centers), classes)] + \
        rng.standard_normal((classes, d)).astype(np.float32) * (
            0.3 / np.sqrt(d))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    protos = protos.astype(np.float32)
    q = (protos[rng.integers(0, classes, mb)]
         + rng.standard_normal((mb, d)).astype(np.float32) * (
             0.1 / np.sqrt(d))).astype(np.float32)
    n, r = dist.world_size(), dist.rank()
    rows = classes // n
    for head in ("full", "knn"):
        for backend in ("ref", "kernel"):
            exp = Experiment.from_config(
                system="paper", classes=classes, feat_dim=d, batch=mb,
                head=_head(head, backend=backend), log_every=0,
                device=device)
            w = torch.from_numpy(protos[r * rows:(r + 1) * rows]).to(
                exp.device)
            exp.load_state(exp.state._replace(head_params=w))
            idx = exp.ivf_index(refit=True)

            def top(**kw):
                eng = exp.serving_engine(top_k=k, max_batch=mb,
                                         max_wait_ms=0.0, cache=None, **kw)
                return np.asarray(eng.step_fn(q.copy(), mb)[0])
            exact = top()
            got = top(index="ivf")
            rec = np.mean([len(set(exact[i]) & set(got[i])) / k
                           for i in range(mb)])
            every = top(index="ivf", nprobe=idx.n_clusters)
            assert (every == exact).all(), (head, backend)
            assert rec >= 0.9, (head, backend, rec)
            _say(f"ivf {head}/{backend} on {n} members: C={idx.n_clusters} "
                 f"cap={idx.cap} nprobe={idx.nprobe} recall@{k}={rec:.3f} "
                 f"nprobe=C exact OK")


def check_replay(paths: list, cached: list) -> None:
    for path, with_cache in zip(paths, cached):
        rows = [json.loads(line) for line in open(path)]
        assert len(rows) == 1, f"{path}: {len(rows)} replay rows"
        r = rows[0]
        assert r["p99_ms"] > 0.0, (path, r)
        assert 0.0 <= r["cache_hit_rate"] <= 1.0, (path, r)
        if with_cache:
            assert r["cache_hit_rate"] > 0.0, (path, r)
        print(f"{path}: p99 {r['p99_ms']:.3f} ms, cache hit rate "
              f"{r['cache_hit_rate']:.3f}")
    print("replay: p99 + cache hit-rate fields OK")


def check_telemetry(root: str) -> None:
    trace = json.load(open(f"{root}/trace.json"))
    steps = [e for e in trace["traceEvents"] if e["name"] == "train.step"]
    assert len(steps) == 5, f"expected 5 train.step spans, got {len(steps)}"
    assert trace["counters"]["train.steps"] == 5.0, trace["counters"]
    rows = [json.loads(line) for line in open(f"{root}/metrics.jsonl")]
    assert len(rows) == 5, f"expected 5 metrics rows, got {len(rows)}"
    print("telemetry: trace parses, 5 train.step spans, 5 metrics rows OK")


RING_LEGS = {"resilience": resilience, "elastic-save": elastic_save,
             "elastic-restore": elastic_restore}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("leg", choices=sorted(RING_LEGS) + [
        "ivf", "check-replay", "check-telemetry"])
    p.add_argument("paths", nargs="*")
    args = p.parse_args(argv)
    if args.leg == "check-replay":
        # PATH[:cached] ...
        check_replay([a.split(":")[0] for a in args.paths],
                     [a.endswith(":cached") for a in args.paths])
        return 0
    if args.leg == "check-telemetry":
        check_telemetry(args.paths[0])
        return 0
    from repro_torch.launch.mesh import launch_ring
    with launch_ring(args.device, share_cards=True):
        if args.leg == "ivf":
            ivf(args.device)
        else:
            RING_LEGS[args.leg](args.paths[0], args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
