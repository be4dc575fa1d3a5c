"""The zoo's ssm, hybrid and encdec trunks on a (data, model) grid of gloo
processes against the JAX package's ``ZooExperiment`` on a mesh of the
same shape, and elastic restores between grids, on the CPU.

The reduced mamba2-370M (2 layers, d_model 128, 8 SSM heads of 32, N 16),
hymba-1.5B (2 layers, d_model 128, 4 attention heads and 2 KV heads, 4
SSM heads of 32, N 8, window 32) and whisper-tiny (2 + 2 layers, 4 heads,
64 frames) in fp32, 8 sequences a step (24 tokens for mamba2, whose scan
then crosses a chunk; 8 for the others), SGD at lr 0.1. Each JAX
experiment is rebuilt on the first devices as a mesh of the grid's shape
(``tests.test_torch_zoo_train.jax_zoo_on_grid``); the port starts from its
params (carried by ``interop``, cut by ``param_pspecs``) and trains on the
same numpy arrays (the JAX package's ``lm_batch`` tokens, numpy frames):

* ``fit(3)`` on (2, 2): the loss and accuracy at every step, the final
  params gathered whole and every member's slices of them within
  ``TRAJ_TOL`` (rtol 1e-4, atol 1e-6), ``evaluate`` within 1e-6, for the
  full head on both backends and the knn head (no fillers), and the full
  head on (1, 2).
* The layout cases: at a model axis of 2 the mixer's leaves split apart.
  mamba2-370M's ``in_proj`` split crosses the z | x boundary (member 0
  holds all of z and x[0:144]) and hymba-1.5B's ``norm_scale`` split cuts
  head 12 in half. The test asserts both layouts on the full configs, and
  ``fit(3)`` on (2, 2) holds four ``dataclasses.replace`` variants to the
  JAX zoo: mamba2 and hymba with 2 groups (their ``in_proj`` split
  crossing the z | x boundary, the SSD's B and C a group a member's
  heads), and mamba2 at d_model 80 and hymba at d_model 160 (5 SSM heads:
  ``in_proj`` and the heads whole, ``norm_scale`` cutting head 2).
* Exact top-5 retrieval on (2, 2): ids equal to the JAX zoo's, scores
  within 1e-5; greedy tokens of mamba2 and hymba on (2, 2), each data
  shard its prompts, on both backends (and of hymba's cut variant, its
  heads whole): equal to the JAX zoo's exactly;
  whisper's greedy decode through ``lm.decode`` on (2, 2) (the cross
  caches of the member's KV heads) equal to the one-process decode's.
* Elastic restores between grids: a mamba2 checkpoint the JAX package
  wrote on (2, 2) restored on the port's (1, 2), and that member's save
  restored on the port's (2, 2), each bit-equal to the JAX package's
  restore of the same file onto the same grid (full, knn and MACH heads),
  the reshard recorded; then ``fit(1)`` within ``TRAJ_TOL``.

The JAX runs go to four processes of their own; the port's (1, 2) grid
runs first (its saves are the (2, 2) grid's restores), then the (2, 2)
grid runs every case of its shape in one spawn.
"""
import concurrent.futures
import contextlib
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro_torch import dist, testing
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.models import ssm as tssm
from repro_torch.resilience import tree_compare
from repro_torch.train import gspmd as tgspmd
from tests.test_torch_zoo_train import HEADS, TRAJ_TOL, _host, jax_zoo_on_grid

ARCHS = ("mamba2_370m", "hymba_1_5b", "whisper_tiny")
SSM_ARCHS = ("mamba2_370m", "hymba_1_5b")
SEQS = {"mamba2_370m": 24, "hymba_1_5b": 8, "whisper_tiny": 8}
BATCH, STEPS, LR = 8, 3, 0.1
BACKENDS = ("ref", "kernel")
GRIDS = {"2x2": (2, 2), "1x2": (1, 2)}
# the layout cases: (arch, fields replaced in its reduced config)
VARIANTS = {
    "mamba2-groups": ("mamba2_370m", {"ssm": {"n_groups": 2}}),
    "hymba-groups": ("hymba_1_5b", {"ssm": {"n_groups": 2}}),
    "mamba2-cut": ("mamba2_370m", {"d_model": 80}),
    "hymba-cut": ("hymba_1_5b", {"d_model": 160}),
}
# (name, head, backend) fits on (2, 2)
FITS = ([(a, h, b) for a in ARCHS for h, b in
         (("full", "ref"), ("full", "kernel"), ("knn", "ref"))]
        + [(v, "full", "ref") for v in VARIANTS])
# greedy decoding on (2, 2): the ssm and hybrid trunks, and hymba's cut
# variant (its heads whole: every member scans every head)
SERVES = SSM_ARCHS + ("hymba-cut",)
ELASTIC_ARCH = "mamba2_370m"
ELASTIC_HEADS = ("full", "knn", "mach")
SERVE = dict(prompt_len=8, gen=4, batch=4)


def _arch(name):
    return VARIANTS[name][0] if name in VARIANTS else name


def _fields(name):
    return VARIANTS[name][1] if name in VARIANTS else None


def _replace(cfg, fields):
    if not fields:
        return cfg
    top = {k: v for k, v in fields.items() if k != "ssm"}
    if "ssm" in fields:
        top["ssm"] = dataclasses.replace(cfg.ssm, **fields["ssm"])
    return dataclasses.replace(cfg, **top)


def _port_cfg(name, full=False):
    cfg = tbase.get_model_config(_arch(name), not full)
    return _replace(cfg, _fields(name))


def _batches(name):
    """The JAX package's lm_batch tokens of steps 0..STEPS-1 (with numpy
    frames for the encdec)."""
    arch = _arch(name)
    fn = jax.jit(jax_lm_batch, static_argnums=(1, 2, 3))
    out = []
    for t in range(STEPS):
        b = _host(fn(t, BATCH, SEQS[arch], 512))
        if arch == "whisper_tiny":
            cfg = tbase.get_model_config(arch, True)
            b["frames"] = np.random.default_rng(100 + t).standard_normal(
                (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# the JAX side (processes of its own)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _jax_variant(fields):
    from repro.api import experiment as jexp
    real = jexp.get_model_config
    if fields:
        jexp.get_model_config = lambda arch, reduced=False: _replace(
            real(arch, reduced), fields)
    try:
        yield
    finally:
        jexp.get_model_config = real


def _jax_exp(key, **kw):
    """The JAX experiment of ``key`` = (name, head, grid) on a mesh of the
    grid's shape, its batches the test's."""
    name, head, grid = key
    with _jax_variant(_fields(name)):
        exp = jax_zoo_on_grid(
            *GRIDS[grid], arch=_arch(name), reduced=True, batch=BATCH,
            seq=SEQS[_arch(name)], head=jbase.HeadConfig(**HEADS[head]),
            train=jbase.TrainConfig(optimizer="sgd", micro_batch=1), **kw)
    batches = _batches(name)
    exp._batch = lambda t: batches[t]
    return exp


def _jax_start(key, queries=None):
    """The JAX experiment's params (the port's start); with ``queries``
    also its exact top-5 of them; for ``SERVES`` on (2, 2) its greedy
    tokens (``SERVE``) and their prompts."""
    exp = _jax_exp(key)
    out = {"tree": _host(exp.params)}
    if queries is not None:
        out["retrieval"] = exp.serve(top_k=5, queries=queries,
                                     return_scores=True)
    if key[0] in SERVES and key[1:] == ("full", "2x2"):
        out["tokens"] = np.asarray(exp.serve(**SERVE))
        out["prompts"] = _host(jax_lm_batch(
            0, SERVE["batch"], SERVE["prompt_len"], 512))["tokens"]
    return key, out


def _jax_fit(key):
    exp = _jax_exp(key)
    hist = exp.fit(STEPS, lr=LR)
    return key, {"history": [dict(r) for r in hist],
                 "params": _host(exp.params),
                 "eval": exp.evaluate(exp._batch(0))}


def _jax_save(head, root):
    """A JAX (2, 2) mamba2 checkpoint at cursor 2 (moments an affine map
    of the params, no step compiled)."""
    jdir = os.path.join(root, f"jax_{head}")
    exp = _jax_exp((ELASTIC_ARCH, head, "2x2"), ckpt_dir=jdir, ckpt_every=2)
    exp.refresh_head()
    exp._ensure_opt()
    with jax.set_mesh(exp.mesh):
        exp.opt_state = exp.opt_state._replace(
            step=exp.opt_state.step + 2, mu=jax.tree.map(
                lambda a: 0.5 * a + 0.25,
                (exp.params, exp.head_state.params)))
    exp._t = 2
    exp.save_checkpoint()
    return jdir


def _jax_restore(head, src, grid):
    """The JAX package's ``restore(reshard=True)`` of the file under
    ``src`` onto a ``grid`` experiment: its snapshot, the reshard's ends,
    then ``fit(1)``'s losses and params."""
    exp = _jax_exp((ELASTIC_ARCH, head, grid), ckpt_dir=src)
    step = exp.restore(reshard=True)
    out = {"step": step, "snap": _host(exp._snapshot()),
           "last_reshard": (exp.last_reshard["src"].describe(),
                            exp.last_reshard["dst"].describe())}
    exp.ckpt_dir = None
    hist = exp.fit(1, lr=LR)
    out.update(losses=[r["loss"] for r in hist], params=_host(exp.params))
    return out


# ---------------------------------------------------------------------------
# the port's grids, and the module's runs
# ---------------------------------------------------------------------------


def _fit_case(start, name, head, backend):
    batches = _batches(name)
    return ("zoo_fit", (start["tree"], dict(HEADS[head], backend=backend),
                        {"optimizer": "sgd", "micro_batch": 1}),
            dict(arch=_arch(name), batch=BATCH, seq=SEQS[_arch(name)],
                 steps=STEPS, lr=LR, batches=batches,
                 eval_inputs=batches[0], variant=_fields(name)))


def _restore_case(head, src, dst=None):
    spec = {"arch": ELASTIC_ARCH, "head": dict(HEADS[head], backend="ref"),
            "batch": BATCH, "seq": SEQS[ELASTIC_ARCH]}
    return ("zoo_grid_restore", (spec, src),
            dict(batches=_batches(ELASTIC_ARCH), dst_dir=dst))


def _port(shape, cases):
    """``cases`` on one spawned grid of ``shape``: {key: per-member}."""
    per_rank = dist.spawn_grid(testing.run_all, *shape,
                               [c for _, c in cases])
    return {k: [r[i] for r in per_rank] for i, (k, _) in enumerate(cases)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX saves, starts, fits and restores in four processes; the
    port's (1, 2) grid (its fits, and restores of the JAX saves that it
    saves again), then its (2, 2) grid with every case of that shape."""
    root = str(tmp_path_factory.mktemp("grid_families"))
    q = np.random.default_rng(5).standard_normal((8, 128)).astype(
        np.float32)
    starts_keys = ([(n, h, "2x2") for n, h in dict.fromkeys(
        (n, h) for n, h, _ in FITS)] + [(a, "full", "1x2") for a in ARCHS])
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true")
    pools = [concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx)
             for _ in range(4)]
    try:
        saves = {h: pools[i].submit(_jax_save, h, root)
                 for i, h in enumerate(ELASTIC_HEADS)}
        starts = dict(f.result() for f in [
            pools[i % 4].submit(
                _jax_start, k,
                q if k[1:] == ("full", "2x2") and k[0] in ARCHS else None)
            for i, k in enumerate(starts_keys)])
        fits = [pools[i % 4].submit(_jax_fit, k)
                for i, k in enumerate(starts_keys)]
        jdirs = {h: f.result() for h, f in saves.items()}
        back12 = {h: pools[(i + 1) % 4].submit(_jax_restore, h, jdirs[h],
                                               "1x2")
                  for i, h in enumerate(ELASTIC_HEADS)}
        pdirs = {h: os.path.join(root, f"port12_{h}") for h in ELASTIC_HEADS}
        small = _port((1, 2), [
            ((a, "full", "ref"), _fit_case(starts[(a, "full", "1x2")], a,
                                           "full", "ref")) for a in ARCHS]
            + [(("restore", h), _restore_case(h, jdirs[h], pdirs[h]))
               for h in ELASTIC_HEADS])
        back22 = {h: pools[(i + 2) % 4].submit(_jax_restore, h, pdirs[h],
                                               "2x2")
                  for i, h in enumerate(ELASTIC_HEADS)}
        cases = [((n, h, b), _fit_case(starts[(n, h, "2x2")], n, h, b))
                 for n, h, b in FITS]
        for a in ARCHS:
            cases.append((("retrieval", a), (
                "zoo_retrieve", (starts[(a, "full", "2x2")]["tree"],
                                 {"softmax_impl": "full"}),
                dict(arch=a, queries=q, top_k=5))))
        for name in SERVES:
            start = starts[(name, "full", "2x2")]
            for b in BACKENDS:
                cases.append((("serve", name, b), ("zoo_serve", (
                    start["tree"],), dict(arch=_arch(name),
                                          prompts=start["prompts"],
                                          gen=SERVE["gen"], backend=b,
                                          variant=_fields(name)))))
        cases += [(("restore", h), _restore_case(h, pdirs[h]))
                  for h in ELASTIC_HEADS]
        whisper = starts[("whisper_tiny", "full", "2x2")]["tree"]
        dec = dict(arch="whisper_tiny", frames=_batches("whisper_tiny")[0][
            "frames"][:4], prompt=starts[("mamba2_370m", "full", "2x2")][
                "prompts"], gen=SERVE["gen"])
        cases.append(("encdec_decode", ("encdec_decode", (whisper,), dec)))
        port = _port((2, 2), cases)
        ring_decode = testing.encdec_decode(whisper, **dec)
        out = {"starts": starts, "refs": dict(f.result() for f in fits),
               "ring_decode": ring_decode,
               "port": port, "small": small,
               "back": {"1x2": {h: f.result() for h, f in back12.items()},
                        "2x2": {h: f.result() for h, f in back22.items()}}}
    finally:
        os.environ["XLA_FLAGS"] = flags
        for p in pools:
            p.shutdown(wait=False)
    return out


def _member_slice(leaf, spec, d, m, grid):
    """Grid member (d, m)'s block of a whole leaf by ``spec``."""
    idx = {"data": d, "model": m}
    size = dict(zip(("data", "model"), grid))
    out = leaf
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = out.shape[dim] // size[entry]
        out = np.take(out, np.arange(idx[entry] * n, (idx[entry] + 1) * n),
                      axis=dim)
    return out


def _check_fit(ref, members, name, grid):
    port = members[0]
    for key in ("loss", "acc"):
        np.testing.assert_allclose([r[key] for r in port["history"]],
                                   [r[key] for r in ref["history"]],
                                   err_msg=key, **TRAJ_TOL)
    got, want = jax.tree.leaves(port["params"]), jax.tree.leaves(
        ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TRAJ_TOL)
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    shape = GRIDS[grid]
    specs = tgspmd.param_pspecs(
        tbase.pad_vocab(_port_cfg(name), shape[1]),
        tmesh.make_host_parallel_config(*shape))
    for i, member in enumerate(members):
        d, m = divmod(i, shape[1])
        assert member["history"] == port["history"]
        for leaf, mine, spec in zip(
                want, jax.tree.leaves(member["member"]),
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                    x, tuple))):
            np.testing.assert_allclose(
                mine, _member_slice(leaf, spec, d, m, shape), **TRAJ_TOL)


# ---------------------------------------------------------------------------
# the layouts
# ---------------------------------------------------------------------------


def _ssm_layout(cfg, n=2):
    """At a model axis of ``n``: which mixer leaves split, where member 0's
    ``in_proj`` columns end among the fused z | x | B | C | dt sections,
    and whether the inner block cuts a head."""
    d_inner, n_heads, d_xbc = tssm.ssm_dims(cfg)
    s = cfg.ssm
    specs = tgspmd.param_pspecs(cfg, tmesh.make_host_parallel_config(1, n))
    sp = specs["blocks"]["ssm"]
    width = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
    ends = {"z": d_inner, "x": 2 * d_inner,
            "bc": 2 * d_inner + 2 * s.n_groups * s.d_state, "dt": width}
    return {"in_proj": "model" in sp["in_proj"],
            "conv": "model" in sp["conv_w"],
            "heads": "model" in sp["dt_bias"],
            "inner": "model" in sp["norm_scale"],
            "member0_in_proj_end": width // n,
            "sections": ends,
            "inner_cuts_a_head": (d_inner // n) % s.head_dim != 0}


def test_the_full_configs_split_apart_at_two():
    """The layouts of the full configs at a model axis of 2: mamba2-
    370M's ``in_proj`` (4,384 columns) splits so member 0 holds all of z
    and x[0:144], its conv 2,304 -> 1,152, ``norm_scale`` 2,048 -> 1,024
    on heads 0-15, the heads 32 -> 16; hymba-1.5B's ``in_proj`` (3,257,
    odd) and heads (25) stay whole, its conv 1,632 -> 816 and its
    ``norm_scale`` 1,600 -> 800 cut head 12 in half."""
    m = _ssm_layout(tbase.get_model_config("mamba2_370m"))
    assert (m["in_proj"], m["conv"], m["heads"], m["inner"]) == (True,) * 4
    assert m["member0_in_proj_end"] == 2192 == 2048 + 144
    assert not m["inner_cuts_a_head"]
    h = _ssm_layout(tbase.get_model_config("hymba_1_5b"))
    assert (h["in_proj"], h["conv"], h["heads"], h["inner"]) == (
        False, True, False, True)
    assert h["inner_cuts_a_head"] and 800 // 64 == 12


@pytest.mark.parametrize("name", list(VARIANTS))
def test_the_layout_cases_split_as_the_full_configs_do(name):
    """Each variant's layout at 2: the ``-groups`` ones split ``in_proj``
    across the z | x boundary (member 0 all of z and part of x) and every
    other leaf on head boundaries; the ``-cut`` ones keep ``in_proj`` and
    the heads whole and cut a head with ``norm_scale``, as hymba-1.5B's
    full config does. The reduced configs themselves split ``in_proj``
    across z | x too."""
    lay = _ssm_layout(_port_cfg(name))
    z_end, x_end = lay["sections"]["z"], lay["sections"]["x"]
    if name.endswith("-groups"):
        assert (lay["in_proj"], lay["conv"], lay["heads"], lay["inner"]) \
            == (True,) * 4
        assert z_end < lay["member0_in_proj_end"] < x_end
        assert not lay["inner_cuts_a_head"]
    else:
        assert (lay["in_proj"], lay["conv"], lay["heads"], lay["inner"]) \
            == (False, True, False, True)
        assert lay["inner_cuts_a_head"]
    base = _ssm_layout(tbase.get_model_config(_arch(name), True))
    assert base["in_proj"] and (base["sections"]["z"]
                                < base["member0_in_proj_end"]
                                < base["sections"]["x"])


# ---------------------------------------------------------------------------
# the fits, retrieval, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FITS, ids=lambda c: "-".join(c))
def test_grid_fit_matches_the_jax_zoo(runs, case):
    """fit(3) on the (2, 2) grid from the JAX run's start: every step's
    loss and accuracy, the final params gathered whole and every member's
    slices, within TRAJ_TOL; evaluate within 1e-6; every member's history
    the same. knn's label recall is in (0, 1] (mamba2's 96 tokens a data
    shard carry more labels than its 10% of slots hold)."""
    name, head, backend = case
    members = runs["port"][case]
    _check_fit(runs["refs"][(name, head, "2x2")], members, name, "2x2")
    if head == "knn":
        assert all(0 < r["label_recall"] <= 1
                   for r in members[0]["history"])


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_fit_on_one_by_two_matches_the_jax_zoo(runs, arch):
    """fit(3) with the full head on the (1, 2) grid against the JAX zoo on
    a (1, 2) mesh, as on (2, 2)."""
    _check_fit(runs["refs"][(arch, "full", "1x2")],
               runs["small"][(arch, "full", "ref")], arch, "1x2")


@pytest.mark.parametrize("arch", ARCHS)
def test_grid_top5_retrieval_matches_the_jax_zoo(runs, arch):
    """Exact top-5 of 8 queries on the (2, 2) grid: ids equal to the JAX
    zoo's, scores within 1e-5."""
    ids, scores = runs["starts"][(arch, "full", "2x2")]["retrieval"]
    for member in runs["port"][("retrieval", arch)]:
        got_ids, got_scores = member["exact"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_scores, scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SERVES)
def test_grid_serve_tokens_equal_the_jax_zoos(runs, name, backend):
    """Greedy decoding on the (2, 2) grid (a prefill of 8, then 3 steps
    through the member's SSM and KV caches), each data shard its two
    prompts: every member's tokens equal the JAX zoo's, exactly; hymba's
    cut variant too, whose heads every member scans."""
    want = runs["starts"][(name, "full", "2x2")]["tokens"]
    for member in runs["port"][("serve", name, backend)]:
        np.testing.assert_array_equal(member, want)


def test_grid_encdec_decode_is_the_one_process_decode(runs):
    """whisper's greedy decode through ``lm.decode`` on the (2, 2) grid
    (the encoder over 4 rows of frames, the cross caches of the member's
    KV heads, a prompt of 8 tokens, then 4 greedy tokens over the split
    vocab): every member's tokens equal the one-process decode's, whose
    decode ``tests/test_torch_zoo_encdec.py`` holds to the JAX package's."""
    want = runs["ring_decode"]
    assert want.shape == (4, SERVE["gen"])
    for member in runs["port"]["encdec_decode"]:
        np.testing.assert_array_equal(member, want)


# ---------------------------------------------------------------------------
# elastic restores between grids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head", ELASTIC_HEADS)
@pytest.mark.parametrize("leg", ["2x2-to-1x2", "1x2-to-2x2"])
def test_elastic_restore_between_grids_matches_the_jax_package(runs, leg,
                                                               head):
    """``restore(reshard=True)`` on one grid of a checkpoint written on a
    grid of another shape (the JAX package's (2, 2) save on the port's
    (1, 2); that member's save on the port's (2, 2)): every member's
    gathered snapshot bit-equal to the JAX package's restore of the same
    file onto the same grid, the reshard recorded (span, counter,
    ``last_reshard``); then fit(1)'s loss and params within TRAJ_TOL of
    the JAX package's."""
    dst = leg.split("-to-")[1]
    ref = runs["back"][dst][head]
    members = (runs["small"] if dst == "1x2" else runs["port"])[
        ("restore", head)]
    for member in members:
        assert member["step"] == ref["step"] == 2 and member["t"] == 2
        cmp = tree_compare(member["snap"], ref["snap"])
        assert cmp["bitwise"], cmp["mismatches"]
        assert "train.reshard" in member["spans"]
        assert member["last_reshard"] == ref["last_reshard"]
        np.testing.assert_allclose(member["losses"], ref["losses"],
                                   **TRAJ_TOL)
        for g, w in zip(jax.tree.leaves(member["params"]),
                        jax.tree.leaves(ref["params"])):
            np.testing.assert_allclose(g, w, **TRAJ_TOL)
