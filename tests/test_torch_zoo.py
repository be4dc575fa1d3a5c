"""The port's zoo token-serving path against the JAX package, on the CPU.

The same inputs, made from a seed with numpy (or the JAX package's own
params and prompts, taken to numpy and carried over by
``repro_torch.interop``), go through the JAX package and through the port:

* configs: the four dense decoders field for field, the arch registry;
* layers: rmsnorm and layernorm, qk-norm, RoPE, the three MLPs, the
  embedding; ``multihead_attention`` on the ``ref`` backend in both of the
  JAX package's branches (direct scores; the q-block x kv-block
  online-softmax scan at S=2048), with GQA, windows and empty cache slots,
  and on the ``kernel`` backend (the flash kernel's plain version on the
  CPU), within 1e-5 in fp32;
* the backbone's hidden states and caches within 1e-5 in fp32 for the
  reduced smollm, qwen3 (qk-norm, GQA), gemma (geglu, MQA), phi3 (untied
  head) and a reduced config with SmolLM-135M's head layout (9 query over
  3 KV heads), on both backends;
* prefill -> decode continuation within 5e-4 of the full forward, as
  ``tests/test_decode.py`` holds the JAX package, and within 1e-5 of the
  JAX package's own decode;
* ``ZooExperiment.serve``'s greedy tokens EXACTLY equal to the JAX
  ``ZooExperiment.serve`` at rings of 1 and 2, on both backends, from the
  JAX experiment's params and prompts (the prompts replace the port's
  ``lm_batch``);
* ``serve_logits_local`` keeps bf16 features' products in fp32, as the JAX
  package's ``preferred_element_type=float32`` does;
* the serve launcher in-process with ``--device cpu --system zoo
  --reduced``, and the arguments it still refuses.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.api.experiment import ZooExperiment as JaxZooExperiment
from repro.configs import base as jbase
from repro.core import sharded_softmax as jss
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import decoder as jdec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import dist, interop, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as tbase
from repro_torch.core import sharded_softmax as tss
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import decoder as tdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from tests.torch_threads import one_thread  # noqa: F401

TOL = 1e-5             # fp32: the same arithmetic, sums in another order
DECODE_TOL = 5e-4      # tests/test_decode.py's bound on decode vs forward
DENSE = ["smollm_135m", "qwen3_1_7b", "gemma_2b", "phi3_mini_3_8b"]
BACKENDS = ["ref", "kernel"]
S = 17                 # deliberately not a multiple of any tile


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch):
    """The reduced config in fp32, in both packages; ``smollm_9x3`` is the
    reduced smollm with SmolLM-135M's head layout."""
    if arch == "smollm_9x3":
        kw = dict(n_heads=9, n_kv_heads=3, d_model=144, dtype="float32")
        return (dataclasses.replace(jbase.get_model_config(
                    "smollm_135m", reduced=True), **kw),
                dataclasses.replace(tbase.get_model_config(
                    "smollm_135m", reduced=True), **kw))
    return (dataclasses.replace(jbase.get_model_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(tbase.get_model_config(arch, reduced=True),
                                dtype="float32"))


@functools.lru_cache(maxsize=None)
def _model(arch, seed=1):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg, tcfg = _cfgs(arch)
    params = jlm.init_model(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, interop.zoo_params_from_numpy(
        tree, tcfg, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_configs_match_the_jax_package(arch, reduced):
    assert (dataclasses.asdict(tbase.get_model_config(arch, reduced))
            == dataclasses.asdict(jbase.get_model_config(arch, reduced)))


def test_arch_registry():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert (dataclasses.asdict(tbase.InputShape("x", 8, 2, "decode"))
            == dataclasses.asdict(jbase.InputShape("x", 8, 2, "decode")))
    for arch in ("smollm-135m", "qwen3.1_7b"):
        assert tbase.normalize_arch_id(arch) == jbase.normalize_arch_id(arch)
    assert tbase.get_model_config("smollm-135m").name == "smollm-135m"
    # every arch id the JAX package knows builds, full and reduced, field
    # for field, and its model initialises (reduced)
    for arch in tbase.ARCH_IDS:
        for reduced in (False, True):
            assert (dataclasses.asdict(tbase.get_model_config(arch, reduced))
                    == dataclasses.asdict(jbase.get_model_config(arch,
                                                                 reduced)))
        cfg = tbase.get_model_config(arch, reduced=True)
        params = tlm.init_model(torch.Generator().manual_seed(0), cfg)
        assert tlm.head_weight(params, cfg).shape == (cfg.vocab_size,
                                                      cfg.d_model)
    with pytest.raises(ValueError, match="unknown arch"):
        tbase.get_model_config("nope")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    jcfg, tcfg = _cfgs("smollm_135m")
    jcfg, tcfg = (dataclasses.replace(c, norm=norm, norm_eps=1e-5)
                  for c in (jcfg, tcfg))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(96).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(96).astype(np.float32)
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              jcfg)
    got = tlayers.apply_norm(tlayers.ParamDict(**jax.tree.map(_t, p)), _t(x),
                             tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    want = jlayers._qk_norm(jnp.asarray(x), jnp.asarray(p["scale"]), 1e-6)
    got = tlayers._qk_norm(_t(x), _t(p["scale"]), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.array([0, 1, 2, 5, 100, 1999, 2047], np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    # bf16 promotes to fp32 inside and comes back bf16, as in JAX
    got16 = tlayers.rope(_t(x).bfloat16(), _t(pos), theta)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlps(activation):
    jcfg, tcfg = (dataclasses.replace(c, activation=activation)
                  for c in _cfgs("smollm_135m"))
    params = jlayers.init_mlp(jax.random.PRNGKey(3), jcfg)
    if activation == "gelu":   # non-zero biases
        params = dict(params, bi=params["bi"] + 0.1, bo=params["bo"] - 0.2)
    x = np.random.default_rng(2).standard_normal((2, 5, 96)).astype(
        np.float32)
    want = jlayers.apply_mlp(params, jcfg, jnp.asarray(x))
    got = tlayers.apply_mlp(tlayers.ParamDict(**jax.tree.map(_t, params)),
                            tcfg, _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


def test_embedding():
    jcfg, tcfg, params, tparams = _model("smollm_135m")
    toks = _tokens(jcfg, 3, 9)
    want = jlayers.apply_embedding(params["embed"], jcfg, jnp.asarray(toks))
    got = tlayers.apply_embedding(tparams.embed, tcfg, _t(toks))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _attn_inputs(b, sq, t, hq, hk, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dh)).astype(np.float32),
            rng.standard_normal((b, t, hk, dh)).astype(np.float32),
            rng.standard_normal((b, t, hk, dh)).astype(np.float32))


# (b, sq, t, hq, hk, dh, causal, window, q positions, k positions)
ATTN_CASES = {
    "direct_gqa": (2, 17, 17, 6, 2, 16, True, None, "rows", "rows"),
    "direct_window": (1, 40, 40, 4, 4, 32, True, 7, "rows", "rows"),
    "direct_noncausal": (1, 12, 20, 2, 1, 16, False, None, "rows", "rows"),
    "decode_slots": (2, 1, 24, 6, 3, 16, True, None, "decode", "slots"),
    "scan_2048": (1, 2048, 2048, 4, 2, 16, True, None, "rows", "rows"),
    "scan_2048_window": (1, 2048, 2048, 2, 1, 16, True, 300, "rows", "rows"),
}


def _positions(kind, n):
    if kind == "rows":
        return np.arange(n, dtype=np.int32)
    if kind == "decode":
        return np.array([14], np.int32)
    slots = np.full(n, -1, np.int32)        # a rotating cache, part filled
    slots[:15] = np.arange(15)
    return slots


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_multihead_attention_ref_matches(case):
    b, sq, t, hq, hk, dh, causal, window, qk, kk = ATTN_CASES[case]
    q, k, v = _attn_inputs(b, sq, t, hq, hk, dh)
    qp, kp = _positions(qk, sq), _positions(kk, t)
    want = jlayers.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp),
        causal=causal, window=window)
    got = tlayers.multihead_attention(
        _t(q), _t(k), _t(v), q_positions=_t(qp), k_positions=_t(kp),
        causal=causal, window=window, backend="ref")
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("window", [None, 5, 300])
@pytest.mark.parametrize("s,hq,hk", [(17, 9, 3), (2048, 2, 1)])
def test_kernel_backend_attention_matches(s, hq, hk, window, monkeypatch):
    """Causal self-attention with ``self_rows`` goes to the flash kernel
    (its plain version on the CPU), GQA from the grouped KV heads, and agrees with
    the JAX package's ``multihead_attention``."""
    calls = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v = _attn_inputs(2, s, s, hq, hk, 16, seed=s)
    pos = np.arange(s, dtype=np.int32)
    want = jlayers.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
        causal=True, window=window)
    rows = torch.arange(s)
    got = tlayers.multihead_attention(
        _t(q), _t(k), _t(v), q_positions=rows, k_positions=rows,
        causal=True, window=window, backend="kernel", self_rows=True)
    assert calls == [{"causal": True, "window": window or 0}]
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=0)
    # without self_rows (decode over cache slots) it takes the ref branches
    tlayers.multihead_attention(_t(q), _t(k), _t(v), q_positions=rows,
                                k_positions=rows, backend="kernel")
    assert len(calls) == 1


def test_kernel_backend_attention_is_forward_only():
    """The flash kernel has no backward (nor has the Pallas kernel): the
    kernel backend's attention raises under grad mode when q, k or v
    requires grad, rather than drop attention's gradient on the card, and
    runs under ``no_grad`` as serving calls it."""
    q, k, v = (_t(a) for a in _attn_inputs(1, 12, 12, 9, 3, 16, seed=5))
    rows = torch.arange(12)
    kw = dict(q_positions=rows, k_positions=rows, backend="kernel",
              self_rows=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tlayers.multihead_attention(q.requires_grad_(True), k, v, **kw)
    with torch.no_grad():
        out = tlayers.multihead_attention(q, k, v, **kw)
    assert out.shape == q.shape


def test_kernel_backend_wants_self_rows():
    """The kernel backend does not quietly run causal self-attention down
    the ref branches: ``apply_attention`` raises without ``self_rows``,
    and ``multihead_attention`` raises when self_rows meets Sq != T."""
    cfg = tbase.get_model_config("smollm_135m", reduced=True)
    p = tlayers.init_attention(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros(1, 8, cfg.d_model)
    rows = torch.arange(8)
    with pytest.raises(ValueError, match="self_rows"):
        tlayers.apply_attention(p, cfg, x, positions=rows, backend="kernel")
    out, _ = tlayers.apply_attention(p, cfg, x, positions=rows,
                                     backend="kernel", self_rows=True)
    assert out.shape == x.shape
    q = torch.zeros(1, 8, 2, 16)
    kv = torch.zeros(1, 9, 2, 16)
    with pytest.raises(ValueError, match="self_rows"):
        tlayers.multihead_attention(q, kv, kv, q_positions=rows,
                                    k_positions=torch.arange(9),
                                    backend="kernel", self_rows=True)


# ---------------------------------------------------------------------------
# backbone, caches, decode
# ---------------------------------------------------------------------------

ARCHS = DENSE + ["smollm_9x3"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_hidden_and_caches_match(arch, backend):
    jcfg, tcfg, params, tparams = _model(arch)
    toks = _tokens(jcfg, 2, S)
    h, _, caches = jlm.backbone(params, jcfg, {"tokens": jnp.asarray(toks)},
                                want_cache=True, cache_window=S + 4)
    with torch.no_grad():
        th, _, tcaches = tlm.backbone(tparams, tcfg, {"tokens": _t(toks)},
                                      want_cache=True, cache_window=S + 4,
                                      backend=backend)
    np.testing.assert_allclose(_np(th), np.asarray(h), atol=TOL, rtol=0)
    for name in ("k", "v"):
        assert tcaches[name].shape == caches[name].shape
        np.testing.assert_allclose(_np(tcaches[name]),
                                   np.asarray(caches[name]), atol=TOL, rtol=0)
    # untied heads: phi3's own [V, D] head, else the embedding table
    np.testing.assert_array_equal(_np(tlm.head_weight(tparams, tcfg)),
                                  np.asarray(jlm.head_weight(params, jcfg)))


def _prefill_decode(arch, backend, n_pre, n_steps, window_cfg=None):
    """Prefill n_pre tokens, decode n_steps, in both packages. Returns
    (jax full-forward hidden, jax decode hiddens, port decode hiddens)."""
    jcfg, tcfg, params, tparams = _model(arch)
    if window_cfg:
        jcfg, tcfg = (dataclasses.replace(c, sliding_window=window_cfg)
                      for c in (jcfg, tcfg))
    toks = _tokens(jcfg, 2, S, seed=5)
    h_full, _, _ = jlm.backbone(params, jcfg, {"tokens": jnp.asarray(toks)})
    window = jlm.decode_window(jcfg, S)
    assert tlm.decode_window(tcfg, S) == window
    _, _, caches = jlm.backbone(params, jcfg,
                                {"tokens": jnp.asarray(toks[:, :n_pre])},
                                want_cache=True, cache_window=window)
    slots = jdec.init_cache_slots(jcfg, window,
                                  prefill_positions=jnp.arange(n_pre))
    with torch.no_grad():
        _, _, tcaches = tlm.backbone(tparams, tcfg, {"tokens": _t(
            toks[:, :n_pre])}, want_cache=True, cache_window=window,
            backend=backend)
    tslots = tdec.init_cache_slots(tcfg, window,
                                   prefill_positions=torch.arange(n_pre))
    np.testing.assert_array_equal(_np(tslots["pos_slots"]),
                                  np.asarray(slots["pos_slots"]))
    jh, th = [], []
    for i in range(n_steps):
        tok = toks[:, n_pre + i:n_pre + i + 1]
        h, caches, slots = jlm.decode(params, jcfg,
                                      {"token": jnp.asarray(tok)}, caches,
                                      slots, window=window)
        with torch.no_grad():
            t, tcaches, tslots = tlm.decode(tparams, tcfg,
                                            {"token": _t(tok)}, tcaches,
                                            tslots, window=window,
                                            backend=backend)
        jh.append(np.asarray(h[:, 0]))
        th.append(_np(t[:, 0]))
        assert int(tslots["pos"]) == int(slots["pos"])
    np.testing.assert_allclose(_np(tcaches["k"]), np.asarray(caches["k"]),
                               atol=TOL, rtol=0)
    return np.asarray(h_full), jh, th


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continuation_matches_full_forward(arch, backend):
    h_full, jh, th = _prefill_decode(arch, backend, S - 1, 1)
    assert np.max(np.abs(th[0] - h_full[:, -1])) < DECODE_TOL
    np.testing.assert_allclose(th[0], jh[0], atol=TOL, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_step_decode_matches_forward(backend):
    h_full, jh, th = _prefill_decode("smollm_135m", backend, S - 5, 5)
    for i in range(5):
        assert np.max(np.abs(th[i] - h_full[:, S - 5 + i])) < DECODE_TOL
        np.testing.assert_allclose(th[i], jh[i], atol=TOL, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sliding_window_decode_bounded_cache(backend):
    h_full, jh, th = _prefill_decode("smollm_135m", backend, S - 1, 1,
                                     window_cfg=8)
    assert np.max(np.abs(th[0] - h_full[:, -1])) < DECODE_TOL
    np.testing.assert_allclose(th[0], jh[0], atol=TOL, rtol=0)


def test_init_decode_state_matches():
    jcfg, tcfg = _cfgs("qwen3_1_7b")
    caches, slots, window = jlm.init_decode_state(jcfg, 3, 12)
    tcaches, tslots, twindow = tlm.init_decode_state(tcfg, 3, 12,
                                                     device="cpu")
    assert twindow == window
    assert tcaches["k"].shape == caches["k"].shape
    assert tcaches["k"].dtype == torch.float32 and not tcaches["k"].any()
    np.testing.assert_array_equal(_np(tslots["pos_slots"]),
                                  np.asarray(slots["pos_slots"]))


# ---------------------------------------------------------------------------
# greedy serving against the JAX package's ZooExperiment
# ---------------------------------------------------------------------------

RINGS = (1, 2)
SERVE = dict(batch=4, prompt_len=12, gen=6)


@pytest.fixture(scope="module")
def jax_serve():
    out = {}
    for n in RINGS:
        exp = JaxZooExperiment(arch="smollm_135m", reduced=True, n_model=n,
                               batch=SERVE["batch"])
        toks = exp.serve(**SERVE)
        cfg = exp.model_cfg
        prompts = np.asarray(jax_lm_batch(
            0, SERVE["batch"], SERVE["prompt_len"],
            cfg.real_vocab_size or cfg.vocab_size)["tokens"])
        out[n] = (jax.tree.map(np.asarray, jax.device_get(exp.params)),
                  prompts, np.asarray(toks))
    return out


@pytest.mark.parametrize("n", RINGS)
def test_zoo_serve_tokens_equal_the_jax_package(jax_serve, n):
    tree, prompts, want = jax_serve[n]
    cases = [("zoo_serve", (tree,), dict(arch="smollm_135m", prompts=prompts,
                                         gen=SERVE["gen"], backend=b))
             for b in BACKENDS]
    per_rank = dist.spawn_ring(testing.run_all, n, cases)
    assert want.shape == (SERVE["batch"], SERVE["gen"])
    for rank_out in per_rank:
        for got in rank_out:
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_zoo_serve_spans_and_counter():
    from repro_torch.telemetry import Tracer
    exp = Experiment.from_config(system="zoo", arch="gemma_2b", reduced=True,
                                 batch=2, device="cpu")
    tr = Tracer()
    toks = exp.serve(prompt_len=5, gen=4, telemetry=tr)
    assert toks.shape == (2, 4)
    assert ((0 <= toks) & (toks < exp.model_cfg.vocab_size)).all()
    assert tr.counters["serve.decoded_tokens"] == 8
    assert tr.span_stats("serve.prefill")["count"] == 1
    assert tr.span_stats("serve.decode")["count"] == 1
    # the port's own prompt stream: deterministic, so is the serve
    np.testing.assert_array_equal(exp.serve(prompt_len=5, gen=4), toks)


def test_zoo_experiment_config_and_unported_parts():
    exp = Experiment.from_config(system="zoo", arch="smollm_135m",
                                 reduced=True, batch=2, device="cpu",
                                 n_model=3)
    jexp_cfg = jbase.pad_vocab(dataclasses.replace(
        jbase.get_model_config("smollm_135m", reduced=True),
        dtype="float32"), 3)
    assert dataclasses.asdict(exp.model_cfg) == dataclasses.asdict(jexp_cfg)
    assert exp.head_cfg.cosine_scale == 0.0 and exp.head_cfg.backend == "kernel"
    # the zoo trainer and its feature retrieval run since their slice
    assert [r["step"] for r in exp.fit(1)] == [0]
    assert 0.0 <= exp.evaluate() <= 1.0
    ids = exp.serve(top_k=5)
    assert ids.shape == (2, 5) and ((0 <= ids) & (ids < 512)).all()
    assert exp.serving_engine(top_k=5).top_k == 5
    # the zoo's checkpoints are ported: a resume wants a ckpt_dir
    with pytest.raises(ValueError, match="ckpt_dir"):
        exp.fit(1, resume=True)
    with pytest.raises(ValueError, match="pass top_k"):
        exp.serve(index="ivf")
    with pytest.raises(ValueError, match="positive"):
        exp.serve(prompt_len=0)
    ck = Experiment.from_config(system="zoo", reduced=True, device="cpu",
                                ckpt_dir="no_such_ckpt_dir")
    assert ck.restore(missing_ok=True) is None
    assert ck.geometry().meta() == {"n_model": 1, "n_data": 1,
                                    "n_classes": 512}
    # the encoder-decoder's token serving refuses, as the JAX package's
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Experiment.from_config(system="zoo", arch="whisper_tiny",
                               reduced=True, device="cpu").serve(
            prompt_len=4, gen=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Experiment.from_config(system="zoo")


def test_zoo_params_from_numpy_checks_the_ring():
    jcfg, tcfg, params, _ = _model("smollm_135m")
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="not on a ring"):
        interop.zoo_params_from_numpy(tree, tcfg, rank=2, world_size=2,
                                      device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        interop.zoo_params_from_numpy(tree, tcfg, rank=0, world_size=3,
                                      device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        interop.zoo_params_from_numpy(
            tree, dataclasses.replace(tcfg, n_layers=3), device="cpu")
    tp = interop.zoo_params_from_numpy(tree, tcfg, rank=1, world_size=2,
                                       device="cpu")
    assert len(tp.blocks) == tcfg.n_layers
    np.testing.assert_array_equal(_np(tp.blocks[1].attn.wq),
                                  tree["blocks"]["attn"]["wq"][1])


def test_lm_batch_is_the_affine_stream():
    out = tsyn.lm_batch(3, 4, 60, 512)
    toks, labels = _np(out["tokens"]), _np(out["labels"])
    assert toks.shape == labels.shape == (4, 60)
    assert ((0 <= toks) & (toks < 512)).all()
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    np.testing.assert_array_equal(_np(tsyn.lm_batch(3, 4, 60, 512)["tokens"]),
                                  toks)
    assert not np.array_equal(_np(tsyn.lm_batch(4, 4, 60, 512)["tokens"]),
                              toks)
    # each row follows t' = (a t + c) mod V, a odd in [3, 15], but for ~5%
    # noise: the best (a, c) explains most transitions
    for row in np.concatenate([toks, labels[:, -1:]], axis=1):
        best = max(np.bincount((row[1:] - a * row[:-1]) % 512).max()
                   for a in range(3, 16, 2))
        assert best >= 0.8 * (len(row) - 1)


def test_serve_logits_local_keeps_bf16_products_in_fp32():
    """bf16 features against an fp32 W: the logits are fp32 sums of exact
    products, as the JAX package's ``preferred_element_type=float32``
    makes them, so rows whose logits differ by less than a bf16 step keep
    their order (bf16 logits would tie them and pick the lowest id)."""
    d, v = 64, 48
    w = np.ones((v, d), np.float32)
    w[:, -1] = 1 + np.arange(v) / 128            # exact in bf16
    f = np.ones((2, d), np.float32)
    f[1] = np.random.default_rng(0).standard_normal(d)
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    fn = jax.shard_map(
        functools.partial(jss.serve_logits_local, model_axis="model"),
        mesh=mesh, in_specs=(P(), P("model", None)),
        out_specs=(P(), P(None, "model")), check_vma=False)
    jids, jlogits = fn(jnp.asarray(f, jnp.bfloat16), jnp.asarray(w))
    ids, logits = tss.serve_logits_local(_t(f).bfloat16(), _t(w))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(_np(ids), np.asarray(jids))
    assert int(ids[0]) == v - 1                  # 64 + 47/128, not a tie


C9_B, C9_V, C9_D = 64, 4096, 576


def _jax_ring1(body, in_specs, out_specs, *args):
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    fn = jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    return jax.device_get(fn(*args))


@pytest.mark.parametrize("site", ["full_softmax_local", "serve_topk_local"])
def test_bf16_features_keep_fp32_products(site):
    """bf16 features against an fp32 class shard (what the zoo trainer
    feeds the heads): the ``ref`` loss body and the top-k serve take the
    product as the JAX package does, operands in bf16 and products and sums
    in fp32, so the loss, logz and top-k scores are fp32 and within 2e-5 of
    JAX's. A product rounded to bf16 is off by up to ~7e-3 a logit here."""
    rng = np.random.default_rng(16)
    f = rng.standard_normal((C9_B, C9_D)).astype(np.float32)
    w = (0.05 * rng.standard_normal((C9_V, C9_D))).astype(np.float32)
    y = rng.integers(0, C9_V, C9_B).astype(np.int32)
    jf = jnp.asarray(f, jnp.bfloat16)
    tf = _t(np.asarray(jf.astype(jnp.float32))).bfloat16()
    if site == "full_softmax_local":
        jl, jm = _jax_ring1(
            functools.partial(jss.full_softmax_local, model_axis="model",
                              batch_axes=(), global_batch=C9_B),
            (P(), P(), P("model", None)), (P(), {"accuracy": P(), "logz": P()}),
            jf, jnp.asarray(y), jnp.asarray(w))
        tl, tm = tss.full_softmax_local(tf, _t(y), _t(w), global_batch=C9_B)
        assert tl.dtype == torch.float32 and tm["logz"].dtype == torch.float32
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=2e-5, rtol=0)
        np.testing.assert_allclose(_np(tm["logz"]), np.asarray(jm["logz"]),
                                   atol=2e-5, rtol=0)
        return
    jv, jg = _jax_ring1(
        functools.partial(jss.serve_topk_local, k=5, model_axis="model"),
        (P(), P("model", None)), (P(), P()), jf, jnp.asarray(w))
    tv, tg = tss.serve_topk_local(tf, _t(w), 5)
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_launcher_serves_the_zoo_on_the_cpu(backend, capsys):
    rc = serve_launcher.main(["--device", "cpu", "--system", "zoo",
                              "--arch", "smollm_135m", "--reduced",
                              "--prompt-len", "16", "--gen", "8",
                              "--batch", "4", "--backend", backend])
    assert rc == 0
    out = capsys.readouterr().out
    assert "generated (4, 8) tokens" in out and "tok/s" in out
    assert "first row:" in out


@pytest.mark.parametrize("argv", [
    # the zoo's --replay, --topk and --index are ported; these still refuse
    ["--system", "zoo", "--index", "ivf"],
    ["--system", "zoo", "--topk", "5", "--nprobe", "3"],
    ["--system", "zoo", "--gen", "0"],
])
def test_launcher_rejects_unported_zoo_args(argv, capsys):
    with pytest.raises(SystemExit) as e:
        serve_launcher.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert (("pass --topk" in err) or ("positive" in err)
            or ("--nprobe only applies" in err))
