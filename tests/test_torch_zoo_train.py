"""The port's zoo trainer against the JAX package's, on the CPU.

The reduced SmolLM in fp32 (2 layers, d_model 96, vocab 512), 4 sequences
of 8 tokens a step, SGD at lr 0.1. Each JAX ``ZooExperiment`` is rebuilt
on a (1, n) (data, model) mesh: the port's ring is the model axis and
every member runs the whole batch, so the knn, selective and sampled
heads, which pick their classes from the batch's labels per shard, see
the batch the JAX package's model axis sees only without a data axis. The
port starts from the JAX experiment's params and head state (the sketch
heads' bucket weights and hashes, selective's LSH tables after the JAX
refresh) carried by ``interop``, trains on the JAX package's ``lm_batch``
arrays, and the sampled head takes the JAX package's draws, injected by
their salt; knn runs without fillers (the JAX package draws them from
``jax.random``, ROADMAP.md C.3) and builds its own graph, rebuilt after
step 2:

* ``fit(3)``'s loss and accuracy at every step, the final params (every
  leaf of the JAX tree, and the sketch heads' bucket weights) within
  ``TRAJ_TOL`` and ``evaluate`` equal, for all six heads on both backends
  (on the CPU ``kernel`` runs the kernels' plain versions; the JAX side
  runs ``ref``) at rings of 1 and 2, and the full and MACH heads at a
  ring of 4; one micro-batch at a ring of 1, two at a ring of 2, and the
  full and MACH heads in two at a ring of 1 too. The full and sketch
  heads score every class, so
  their numbers do not depend on the ring and one JAX run at n_model 1 is
  their reference at every ring. Every member ends with bit-equal params
  and history.
* one batch's gradient through ``make_head_loss_fn`` at rings of 1, 2
  and 4 against the JAX package's at n_model 1, 2 and 4 on its default
  (8 / n, n) mesh: the JAX zoo's gradient is that of the mean loss
  whatever the ring, and so is the port's;
* ``auto_micro_batches`` over a table of shapes, the two back-compat
  shims, the param tree's order, the spans and counters of ``fit``, and
  the train launcher with ``--system zoo`` for each head, and its
  checkpoint flags' checks (the zoo's checkpoints themselves are held to
  the JAX package's in ``tests/test_torch_zoo_checkpoint.py``).

The JAX runs go to four processes of their own while the port's rings
run in theirs.
"""
import concurrent.futures
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.api.experiment import ZooExperiment as JaxZooExperiment
from repro.api.heads import HeadState as JaxHeadState
from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.launch.mesh import make_host_parallel_config
from repro.train import gspmd as jgspmd
from repro_torch import dist, interop, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as tbase
from repro_torch.core import baselines as tbl
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers as tlayers
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.train import gspmd as tgspmd
from tests.test_torch_heads import _jax_draw
from tests.torch_threads import one_thread  # noqa: F401

ARCH = "smollm_135m"
BATCH, SEQ, STEPS, LR = 4, 8, 3, 0.1
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
BACKENDS = ("ref", "kernel")
HEADS = {
    "full": dict(softmax_impl="full"),
    # no fillers: the JAX package draws them from jax.random (ROADMAP C.3)
    "knn": dict(softmax_impl="knn", knn_k=4, knn_kprime=8, rebuild_every=2,
                knn_pad_random=False),
    "selective": dict(softmax_impl="selective", rebuild_every=100),
    "mach": dict(softmax_impl="mach", mach_b=32, mach_r=2),
    "sampled": dict(softmax_impl="sampled", sampled_n=128),
    "csoft": dict(softmax_impl="csoft", csoft_b=32, csoft_r=2),
}
# (ring, head, n_micro): every head in one micro-batch at a ring of 1 and
# in two at a ring of 2 (where the knn, selective and sampled heads pick
# their classes per micro-batch and shard, and the sketch heads' bucket
# blocks train beside the model through the micro-batch loop); the full
# and MACH heads also in two at a ring of 1
CASES = ([(1, h, 1) for h in HEADS]
         + [(1, "full", 2), (1, "mach", 2)]
         + [(2, h, 2) for h in HEADS]
         + [(4, "full", 1), (4, "mach", 1)])
GRAD_RINGS = (1, 2, 4)
RING_FREE = ("full", "mach", "csoft")


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def jax_zoo_on_ring(n, **kw):
    """A JAX ``ZooExperiment`` (``kw``: its arguments) rebuilt on a (1, n)
    mesh, its params and head state moved onto it: the port's ring has no
    data axis, and the knn, selective and sampled heads pick their classes
    per data shard. Its optimizer state is made and placed as its restore
    places it (the moments as the params, the step replicated), so the
    first step's inputs are committed as every later step's are and the
    step compiles once."""
    return jax_zoo_on_grid(1, n, **kw)


def jax_zoo_on_grid(n_data, n_model, par=None, **kw):
    """``jax_zoo_on_ring`` on an (n_data, n_model) mesh of the first
    n_data * n_model devices, the port's grid, under ``par`` (by default
    ``make_host_parallel_config(n_data, n_model)``)."""
    n = n_data * n_model
    exp = JaxZooExperiment(n_model=n_model, log_every=0, **kw)
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n_data, n_model),
                ("data", "model"))
    par = par or make_host_parallel_config(n_data, n_model)
    params, hp, aux = _host((exp.params, exp.head_state.params,
                             exp.head_state.aux))
    exp.mesh, exp.par, exp._n_data = mesh, par, n_data

    def put(tree, spec):
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree,
            spec)
    with jax.set_mesh(mesh):
        shards = jgspmd.param_shardings(exp.model_cfg, par, mesh)
        exp.params = jax.tree.map(jax.device_put, params, shards)
        hp_spec = exp.head.params_spec(exp._maxis)
        exp.head_state = JaxHeadState(
            put(hp, hp_spec) if jax.tree.leaves(hp) else (),
            put(aux, exp.head.aux_spec(exp._maxis)))
        exp._ensure_opt()
        moments = (shards, jax.tree.map(lambda s: NamedSharding(mesh, s),
                                        hp_spec)
                   if jax.tree.leaves(hp) else ())
        opt = exp.opt_state
        exp.opt_state = jax.tree.map(jax.device_put, opt, type(opt)(
            step=NamedSharding(mesh, P()), mu=moments,
            nu=None if opt.nu is None else moments))
    return exp


def _jax_zoo(n, head, n_micro=1):
    """The JAX ZooExperiment with ``head`` on a (1, n) mesh."""
    return jax_zoo_on_ring(
        n, arch=ARCH, reduced=True, batch=BATCH, seq=SEQ,
        head=jbase.HeadConfig(**HEADS[head]),
        train=jbase.TrainConfig(optimizer="sgd", micro_batch=n_micro))


def _draws(n, n_micro, batches):
    """The JAX package's sampled draw of every member for every micro-batch
    of the run, keyed by its salt."""
    v_loc = 512 // n
    out = {}
    for t, b in enumerate(batches):
        labels = b["labels"].reshape(n_micro, -1)
        for y in labels:
            salt = tbl.sampled_salt(torch.from_numpy(y), t)
            out[salt] = [_jax_draw(y, t, p, n, v_loc=v_loc,
                                   n_samples=HEADS["sampled"]["sampled_n"],
                                   distribution="uniform")
                         for p in range(n)]
    return out


def _ref_key(case):
    """The JAX run that is ``case``'s reference: the full and sketch heads'
    numbers do not depend on the ring (their classes are all scored), so
    one run at n_model 1 serves every ring; knn, selective and sampled
    pick classes per shard and need the run at the case's ring."""
    n, head, n_micro = case
    return (1, head, n_micro) if head in RING_FREE else case


def _batches():
    """The JAX experiments' batches (``lm_batch`` under jit: integer
    arithmetic, the same values as the experiments' own calls)."""
    fn = jax.jit(jax_lm_batch, static_argnums=(1, 2, 3))
    return [_host(fn(t, BATCH, SEQ, 512)) for t in range(STEPS)]


def _jax_experiment(key):
    """The JAX experiment of run ``key``, its selective tables refreshed
    (the tables carried to the port)."""
    n, head, n_micro = key
    exp = _jax_zoo(n, head, n_micro)
    if head == "selective":
        exp.refresh_head()
    batches = _batches()
    exp._batch = lambda t: batches[t]
    return exp


def _jax_head_state(key):
    exp = _jax_experiment(key)
    hp, aux = _host((exp.head_state.params, exp.head_state.aux))
    return key, {"params": hp, "aux": list(aux)}


def _jax_fit(key):
    """The JAX run ``key`` = (n, head, n_micro): its history, final params
    (and bucket weights) and evaluation on the first batch. Every JAX draw
    is seeded, so a process of its own starts from the params, head state
    and batches the port is given."""
    exp = _jax_experiment(key)
    hist = exp.fit(STEPS, lr=LR)
    return {"history": [dict(r) for r in hist], "params": _host(exp.params),
            "eval": exp.evaluate(exp._batch(0)),
            "head_params": (None if exp.head.params_are_class_weights
                            else _host(exp.head_state.params))}


def _starts(head_states):
    """The port's starting point of every case: the JAX experiment's
    params and batches (the same for every head and ring), the head state
    of the JAX run it is held to (``head_states``: the sketch heads' bucket
    weights and hashes, selective's tables refreshed on the case's ring),
    and the sampled head's draws."""
    tree = _host(_jax_zoo(1, "full").params)
    batches = _batches()
    starts = {}
    for case in CASES:
        n, head, n_micro = case
        starts[case] = {"tree": tree, "batches": batches,
                        "head_state": head_states.get(_ref_key(case))}
        if head == "sampled":
            starts[case]["draws"] = _draws(n, n_micro, batches)
    return starts


def _jax_grads(n):
    """One batch's loss and gradient through the JAX package's
    ``make_head_loss_fn`` on its default (8 / n, n) mesh."""
    exp = JaxZooExperiment(arch=ARCH, reduced=True, n_model=n, batch=BATCH,
                           seq=SEQ, log_every=0)
    inputs = _host(exp._batch(0))
    with jax.set_mesh(exp.mesh):
        loss_fn = jgspmd.make_head_loss_fn(
            exp.model_cfg, exp.head_cfg, exp.par, exp.mesh,
            global_tokens=BATCH * SEQ, head=exp.head)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, (), (), inputs), has_aux=True))(exp.params)
    return n, {"tree": _host(exp.params), "inputs": inputs,
               "loss": float(loss), "grads": _host(grads)}


def _port_ring(n, starts, grads):
    """Every port case of the ring of n: each case's fit on both backends,
    then the gradient case. {key: per-member results}."""
    cases, keys = [], []
    for case, st in starts.items():
        if case[0] != n:
            continue
        for backend in BACKENDS:
            kw = dict(arch=ARCH, batch=BATCH, seq=SEQ, steps=STEPS, lr=LR,
                      batches=st["batches"], eval_inputs=st["batches"][0],
                      head_state=st.get("head_state"),
                      draws=st.get("draws"))
            cases.append(("zoo_fit", (st["tree"],
                                      dict(HEADS[case[1]], backend=backend),
                                      {"optimizer": "sgd",
                                       "micro_batch": case[2]}), kw))
            keys.append(case + (backend,))
    g = grads[n]
    cases.append(("zoo_grads", (g["tree"], {"softmax_impl": "full"}),
                  dict(arch=ARCH, inputs=g["inputs"])))
    keys.append(("grads", n))
    per_rank = dist.spawn_ring(testing.run_all, n, cases)
    return {key: [r[i] for r in per_rank] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def results():
    """(JAX references by port case, JAX gradients, port results, JAX
    shims). The
    JAX runs go to four processes of their own; this one makes the
    starts, then the port's rings run, each in its own processes."""
    rings = sorted({c[0] for c in CASES})
    # the slowest first: the runs on a mesh of 2 compile the longest
    keys = sorted({_ref_key(c) for c in CASES}, key=lambda k: (-k[0], k))
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    with concurrent.futures.ProcessPoolExecutor(4, mp_context=ctx) as procs, \
            concurrent.futures.ThreadPoolExecutor(len(rings)) as pool:
        # the JAX processes compile on one thread each (four such beside
        # the port's rings use the cores better than four pools of all),
        # without LLVM's costly passes: their programs are tiny, their
        # compiles are the file's time
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_cpu_multi_thread_eigen=false"
            " intra_op_parallelism_threads=1"
            " --xla_backend_optimization_level=0"
            " --xla_llvm_disable_expensive_passes=true")
        try:
            shims = procs.submit(_jax_shims)
            grads = procs.map(_jax_grads, GRAD_RINGS)
            head_states = procs.map(_jax_head_state, [
                k for k in keys if k[1] in ("selective", "mach", "csoft")])
            refs = procs.map(_jax_fit, keys)
        finally:
            os.environ["XLA_FLAGS"] = flags
        starts = _starts(dict(head_states))
        grads = dict(grads)
        port = [pool.submit(_port_ring, n, starts, grads) for n in rings]
        refs = dict(zip(keys, refs))
        return ({c: refs[_ref_key(c)] for c in CASES}, grads,
                {k: v for f in port for k, v in f.result().items()},
                shims.result())


def _flat(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"ring{c[0]}-{c[1]}-"
                         f"micro{c[2]}")
def test_fit_matches_the_jax_zoo(results, case, backend):
    """fit(3) from the JAX run's start: every step's loss and accuracy,
    the final params and bucket weights within TRAJ_TOL, evaluate equal;
    every member ends with bit-equal params and history, and the
    weights_version moves on every step."""
    ref = results[0][case]
    members = results[2][case + (backend,)]
    port = members[0]
    for key in ("loss", "acc"):
        np.testing.assert_allclose([r[key] for r in port["history"]],
                                   [r[key] for r in ref["history"]],
                                   err_msg=key, **TRAJ_TOL)
    assert [r["step"] for r in port["history"]] == list(range(STEPS))
    got, want = _flat(port["params"]), _flat(ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TRAJ_TOL)
    if ref["head_params"] is not None:
        np.testing.assert_allclose(port["head_params"], ref["head_params"],
                                   **TRAJ_TOL)
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    versions = port["versions"]
    assert len(set(versions[1:])) == STEPS + 1
    for other in members[1:]:
        assert other["history"] == port["history"]
        for a, b in zip(_flat(other["params"]), got):
            np.testing.assert_array_equal(a, b)
    if case[1] in ("knn", "selective"):
        assert all(r["label_recall"] == 1.0 for r in port["history"])
    if case[1] == "sampled":
        assert all(r["sample_frac"] == 0.25 for r in port["history"])


@pytest.mark.parametrize("n", GRAD_RINGS)
def test_gradient_is_the_jax_zoos_at_every_ring(results, n):
    """The JAX zoo's gradient at n_model 1, 2, 4 (data axes 8, 4, 2) is
    that of the mean loss, the same at every n; the port's at rings of 1,
    2, 4 matches it leaf for leaf, the tied table's embedding and head
    parts together, on every member."""
    ref = results[1][n]
    want = _flat(ref["grads"])
    for member in results[2][("grads", n)]:
        assert member["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        got = _flat(member["grads"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)
    for a, b in zip(want, _flat(results[1][1]["grads"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# the step builders' helpers and shims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,reduced", [("smollm_135m", False),
                                          ("smollm_135m", True),
                                          ("qwen3_1_7b", False)])
def test_auto_micro_batches_matches_jax(arch, reduced):
    tcfg = tbase.get_model_config(arch, reduced)
    jcfg = jbase.get_model_config(arch, reduced)
    for batch, seq in ((1, 8192), (16, 512), (64, 512), (256, 4096),
                       (24, 2048), (8, 100_000), (6, 4096)):
        # the ring has no data axis: the JAX count on one data shard
        for n_model in (1, 8):
            want = jgspmd.auto_micro_batches(
                jcfg, make_host_parallel_config(1, n_model),
                jbase.InputShape("x", seq, batch, "train"))
            got = tgspmd.auto_micro_batches(
                tcfg, tbase.InputShape("x", seq, batch, "train"))
            assert got == want, (batch, seq, n_model)
            assert (tgspmd._step_tokens(tcfg, tbase.InputShape(
                "x", seq, batch, "train")) == batch * seq)
    assert tgspmd.vocab_axes() == ("model", ("model",), ("data",))
    assert tgspmd.n_vocab_shards() == 1


def _jax_shims():
    """The JAX package's shims on one device: ``make_loss_fn`` with the knn
    graph (cosine logits) and its gradient, ``make_train_step`` (the full
    head's raw logits, one SGD step)."""
    from repro.optim import make_optimizer as jopt
    jexp = _jax_zoo(1, "knn")
    inputs = _batches()[0]
    hcfg = jbase.HeadConfig(softmax_impl="full", knn_pad_random=False)
    aux = _host(jexp.head_state.aux)
    tcfg = jbase.TrainConfig(optimizer="sgd")
    with jax.set_mesh(jexp.mesh):
        jloss = jgspmd.make_loss_fn(jexp.model_cfg, hcfg, jexp.par, jexp.mesh,
                                    global_tokens=BATCH * SEQ, use_knn=True)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, inputs, aux), has_aux=True))(jexp.params)
        jstep = jgspmd.make_train_step(
            jexp.model_cfg, hcfg, jexp.par, tcfg, jexp.mesh,
            jbase.InputShape("x", SEQ, BATCH, "train"))
        params, _, loss2, _ = jax.jit(jstep)(
            jexp.params, jopt(tcfg).init(jexp.params), inputs, 0.5)
    return {"tree": _host(jexp.params), "inputs": inputs, "aux": aux,
            "loss": float(loss), "grads": _host(grads),
            "step_loss": float(loss2), "params": _host(params)}


def test_shims_match_jax(results):
    """``make_loss_fn`` with the knn graph (cosine logits) and
    ``make_train_step`` (the full head's raw logits, one SGD step) against
    the JAX package's shims on one device."""
    ref = results[3]
    tcfg = dataclasses.replace(tbase.get_model_config(ARCH, True),
                               dtype="float32")
    params = interop.zoo_params_from_numpy(ref["tree"], tcfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in ref["inputs"].items()}
    graph = tuple(torch.as_tensor(a[0]) for a in ref["aux"])
    tloss = tgspmd.make_loss_fn(tcfg, tbase.HeadConfig(knn_pad_random=False),
                                global_tokens=BATCH * SEQ, use_knn=True)
    from repro_torch.core.pipeline import microbatched_value_and_grad
    (tl, _), tg = microbatched_value_and_grad(
        lambda p, x: tloss(p, x, graph), params, batch, 1)
    assert float(tl) == pytest.approx(ref["loss"], rel=1e-5)
    # cosine logits at scale 16 amplify fp32 sums in another order: each
    # leaf within 1e-5 of its own max (read ~1e-6)
    for a, b in zip(_flat(interop.zoo_params_to_numpy(tg)),
                    _flat(ref["grads"])):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    from repro_torch.optim import make_optimizer
    tcfg_t = tbase.TrainConfig(optimizer="sgd")
    step = tgspmd.make_train_step(tcfg, tbase.HeadConfig(), tcfg_t,
                                  tbase.InputShape("x", SEQ, BATCH, "train"))
    tp, _, tl2, _ = step(params, make_optimizer(tcfg_t).init(params), batch,
                         0.5)
    assert float(tl2) == pytest.approx(ref["step_loss"], rel=1e-5)
    for a, b in zip(_flat(interop.zoo_params_to_numpy(tp)),
                    _flat(ref["params"])):
        np.testing.assert_allclose(a, b, **TRAJ_TOL)


def test_param_tree_walks_in_sorted_key_order():
    """``tree_leaves`` walks a ParamDict in sorted-key order and its layers
    in index order, as ``jax.tree.flatten`` walks the JAX package's dicts
    (the stacked [L] leaves one layer at a time); ``tree_map`` rebuilds
    it as a ParamDict; ``zoo_params_to_numpy`` inverts
    ``zoo_params_from_numpy``; fresh params do not require grad."""
    cfg = dataclasses.replace(tbase.get_model_config(ARCH, True),
                              dtype="float32")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models import lm
    params = lm.init_model(gen, cfg)
    tree = interop.zoo_params_to_numpy(params)
    back = interop.zoo_params_from_numpy(tree, cfg, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
    assert not any(p.requires_grad for p in tree_leaves(params))
    assert list(params) == ["blocks", "embed", "ln_f"]
    assert list(params.blocks[0].attn) == ["wk", "wo", "wq", "wv"]
    leaves = tree_leaves(params)
    order = [id(p) for p in leaves]
    want = ([id(x) for b in params.blocks
             for m in ("attn", "ln1", "ln2", "mlp")
             for x in b[m].values()]
            + [id(params.embed.table), id(params.ln_f.scale)])
    assert order == want
    # the JAX package's flatten order, the [L] axis taken layer by layer
    jnames = [jax.tree_util.keystr(k) for k, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    blocks = [n[len("['blocks']"):] for n in jnames
              if n.startswith("['blocks']")]
    want = [f"['blocks'][{i}]{n}" for i in range(cfg.n_layers)
            for n in blocks] + [n for n in jnames
                                if not n.startswith("['blocks']")]

    def names(node, path=""):
        if isinstance(node, dict):
            return [x for k, v in node.items()
                    for x in names(v, f"{path}['{k}']")]
        if isinstance(node, list):
            return [x for i, v in enumerate(node)
                    for x in names(v, f"{path}[{i}]")]
        return [path]
    assert names(params) == want and len(want) == len(leaves)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    assert isinstance(live, tlayers.ParamDict)
    assert all(p.requires_grad for p in tree_leaves(live))
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(tree_leaves(live), leaves))
    assert live["embed"]["table"] is live.embed.table


def test_fit_spans_counters_graph_and_refusals(tmp_path):
    """``fit``'s spans and counters, one metrics row a step with the knn
    head's own metrics, the refresh cadence, the graph back-compat API;
    ``fit(resume=...)`` wants a ``ckpt_dir``, and with one a checkpoint
    lands at the end of ``fit``; top-k refuses the sketch heads."""
    from repro_torch.telemetry import Tracer
    exp = Experiment.from_config(
        system="zoo", arch=ARCH, reduced=True, batch=2, seq=8, device="cpu",
        head=tbase.HeadConfig(softmax_impl="knn", knn_k=4, knn_kprime=8,
                              rebuild_every=1), log_every=0)
    tr = Tracer()
    hist = exp.fit(2, telemetry=tr)
    assert [r["step"] for r in hist] == [0, 1]
    assert all(r["label_recall"] == 1.0 and 0 < r["active_frac"] <= 1
               for r in hist)
    assert tr.counters["train.steps"] == 2
    assert tr.counters["train.refreshes"] == 2
    for name in ("train.data", "train.step", "train.refresh"):
        assert tr.span_stats(name)["count"] == 2
    assert exp.weights_version == (0, 2)
    graph = exp.rebuild_graph()
    assert len(graph) == 3 and graph is exp.graph
    exp.graph = None
    assert not exp._refreshed
    exp.graph = graph
    assert exp._refreshed
    assert all(a is b for a, b in zip(exp.graph, graph))
    assert 0.0 <= exp.evaluate() <= 1.0
    with pytest.raises(ValueError, match="ckpt_dir"):
        exp.fit(1, resume=True)
    exp.ckpt_dir = str(tmp_path / "ck")
    exp.fit(1, telemetry=tr)
    assert tr.span_stats("train.checkpoint")["count"] == 1
    assert os.listdir(exp.ckpt_dir) == ["ckpt_3.msgpack.zst"]
    mach = Experiment.from_config(
        system="zoo", arch=ARCH, reduced=True, batch=2, seq=8, device="cpu",
        head=tbase.HeadConfig(softmax_impl="mach", mach_b=32, mach_r=2),
        log_every=0)
    assert mach.graph is None
    w0 = mach.head_state.params.clone()
    mach.fit(1)
    assert not torch.equal(mach.head_state.params, w0)
    with pytest.raises(NotImplementedError, match="full/knn/selective"):
        mach.serve(top_k=3)


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", list(HEADS))
def test_train_launcher_zoo_on_the_cpu(head, tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    rc = train_launcher.main([
        "--device", "cpu", "--system", "zoo", "--arch", ARCH, "--reduced",
        "--batch", "2", "--seq", "8", "--steps", "2", "--lr", "0.5",
        "--head", head, "--metrics-out", str(metrics)])
    assert rc == 0
    assert "[zoo] final next-token accuracy" in capsys.readouterr().out
    rows = metrics.read_text().splitlines()
    assert len(rows) == 2 and '"loss"' in rows[-1]


@pytest.mark.parametrize("argv,err", [
    (["--ckpt-dir", "ck", "--ckpt-keep", "0"], "--ckpt-keep must be >= 1"),
    (["--ckpt-dir", "ck", "--ckpt-every", "-1"], "--ckpt-every must be >= 0"),
    (["--resume"], "--resume requires --ckpt-dir")],
    ids=["argv0", "argv1", "argv2"])
def test_train_launcher_refuses_zoo_checkpoints(argv, err, capsys):
    """The zoo's checkpoint flags run (tests/test_torch_zoo_checkpoint.py)
    and go through the paper system's checks: bad values are an argparse
    error (the name is kept from when the zoo refused every one, naming
    ROADMAP.md A.9.3)."""
    with pytest.raises(SystemExit) as e:
        train_launcher.main(["--device", "cpu", "--system", "zoo",
                             "--reduced"] + argv)
    assert e.value.code == 2
    assert err in capsys.readouterr().err
