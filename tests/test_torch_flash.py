"""The port's flash attention against the JAX package's Pallas kernel, on
the CPU.

The same inputs, made from a seed with numpy, go through
``repro.kernels.flash_attention.flash_attention`` in interpret mode (at the
block sizes of the JAX test's sweep) and through the port: its plain
version, ``flash_attention_plain`` (the TPU kernel's tile loop in torch
ops, at the CUDA kernel's key tiles), and the public wrappers
``flash_attention`` and ``ops.flash_attention``, which on CPU tensors run
that plain version. The sweep is ``tests/test_flash_kernel.py``'s (ragged
Sq != T with kv padding, non-causal; a sliding window of 100; Dh 32, 64
and 128) plus Dh 96 and 256 and a case whose rows from 149 on have no
valid key (Sq=300, T=100, causal, window 50), which must come out 0.
Grouped KV heads (g = 1, 3, 8) equal the same heads expanded, and
``ops.flash_attention`` is forward only: it raises under grad.

Tolerances are the JAX test's own: fp32 within atol 2e-5 (fp32 sums in
another order and over other tiles), bf16 within atol 3e-2 against the
fp32 oracle, and the port's bf16 within the same 3e-2 of the Pallas
kernel's bf16. The CUDA kernel is held against the plain version on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from tests.torch_threads import one_thread  # noqa: F401

FP32_ATOL = 2e-5
BF16_ATOL = 3e-2

# (bh, s, t, dh, causal, window, bq, bkv): tests/test_flash_kernel.py's
# sweep, then Dh 96 and 256, then rows with no valid key
SWEEP = [
    (4, 256, 256, 64, True, 0, 128, 128),
    (2, 200, 300, 32, False, 0, 64, 128),   # ragged + padding
    (3, 256, 256, 64, True, 100, 64, 64),   # sliding window
    (1, 512, 512, 128, True, 0, 128, 256),
    (2, 192, 192, 96, True, 0, 64, 64),     # phi3's head dim
    (1, 130, 130, 256, True, 0, 64, 64),    # gemma's head dim
    (2, 300, 100, 32, True, 50, 64, 64),    # rows >= 149: no valid key
]

def _inputs(bh, s, t, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, s, dh)).astype(np.float32),
            rng.standard_normal((bh, t, dh)).astype(np.float32),
            rng.standard_normal((bh, t, dh)).astype(np.float32))


def _oracle(q, k, v, causal, window):
    """Dense softmax attention in float64 (numpy)."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bsd,btd->bst", q, k) / np.sqrt(q.shape[-1])
    qp = np.arange(q.shape[1])[:, None]
    kp = np.arange(k.shape[1])[None, :]
    valid = np.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        valid &= kp <= qp
    if window:
        valid &= kp > qp - window
    s = np.where(valid[None], s, -np.inf)
    mx = np.max(s, axis=-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(mx), mx, 0.0))
    den = p.sum(-1, keepdims=True)
    p = np.where(den > 0, p / np.where(den > 0, den, 1.0), 0.0)
    return np.einsum("bst,btd->bsd", p, v)


@pytest.mark.parametrize("bh,s,t,dh,causal,window,bq,bkv", SWEEP)
def test_flash_matches_the_pallas_kernel(bh, s, t, dh, causal, window, bq,
                                         bkv):
    q, k, v = _inputs(bh, s, t, dh, seed=bh * s + t + dh)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               block_q=bq, block_kv=bkv))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      window=window).numpy()
    wrapped = tops.flash_attention(tq, tk, tv, causal=causal,
                                   window=window).numpy()
    np.testing.assert_allclose(plain, ref, atol=FP32_ATOL, rtol=0)
    np.testing.assert_array_equal(wrapped, plain)
    np.testing.assert_allclose(plain, _oracle(q, k, v, causal, window),
                               atol=FP32_ATOL, rtol=0)
    if window and t < s:
        # rows whose band holds no key: 0 in both, not NaN
        empty = np.arange(s) - window + 1 >= t
        assert empty.any()
        assert not np.any(plain[:, empty]) and not np.any(ref[:, empty])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    """The JAX test's dtype case: the output keeps the input dtype and lies
    within the JAX test's tolerance of the fp32 oracle, and of the Pallas
    kernel run in the same dtype."""
    q, k, v = _inputs(2, 128, 128, 64, seed=9)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=64, block_kv=64),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)
                  for a in (jq, jk, jv))
    out = tfa.flash_attention(tq, tk, tv)
    assert out.dtype == td
    atol = BF16_ATOL if dtype == "bfloat16" else FP32_ATOL
    oracle = _oracle(*(np.asarray(a.astype(jnp.float32)) for a in (jq, jk, jv)),
                     True, 0)
    np.testing.assert_allclose(out.float().numpy(), oracle, atol=atol, rtol=0)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("g", [1, 3, 8])
def test_grouped_kv_heads_equal_expanded_heads(g):
    """GQA without copies: k and v with BH / g heads (g = 3 as SmolLM's 9
    over 3) give exactly the plain version on heads expanded by
    ``repeat_interleave`` (query head h reads KV head h // g), and match
    the Pallas kernel in interpret mode on the expanded heads."""
    bh, s, dh = 2 * g, 150, 64
    rng = np.random.default_rng(g)
    q = rng.standard_normal((bh, s, dh)).astype(np.float32)
    k, v = (rng.standard_normal((bh // g, s, dh)).astype(np.float32)
            for _ in range(2))
    ke, ve = (np.repeat(a, g, axis=0) for a in (k, v))
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(ke),
                               jnp.asarray(ve), window=60, block_q=64,
                               block_kv=64))
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv, tke, tve = (torch.from_numpy(a).to(dtype)
                                for a in (q, k, v, ke, ve))
        grouped = tops.flash_attention(tq, tk, tv, window=60)
        expanded = tfa.flash_attention_plain(tq, tke, tve, window=60)
        assert grouped.dtype == dtype
        assert torch.equal(grouped, expanded)
    np.testing.assert_allclose(
        tfa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  window=60).numpy(), ref, atol=FP32_ATOL,
        rtol=0)


@pytest.mark.parametrize("grad_input", ["q", "k", "v"])
def test_flash_attention_raises_under_grad(grad_input):
    """Forward only, as the Pallas kernel (no custom_vjp): with grad mode on
    and an input that requires grad, ``ops.flash_attention`` raises on
    every device (on the card the output would carry no gradient) and
    points at ROADMAP A.9.1; under ``no_grad`` it runs."""
    x = {n: torch.randn(3, 40, 32) for n in "qkv"}
    x[grad_input].requires_grad_(True)
    with pytest.raises(RuntimeError, match="A.9.1"):
        tops.flash_attention(x["q"], x["k"], x["v"])
    with torch.no_grad():
        out = tops.flash_attention(x["q"], x["k"], x["v"])
    assert out.shape == (3, 40, 32) and not out.requires_grad


def test_plain_version_does_not_depend_on_its_tiles():
    """The kv tiles only change the order of fp32 sums: the plain version
    at the TPU kernel's 128-key tiles agrees with it at the CUDA kernel's
    64."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 250, 250, 32, seed=4))
    a = tfa.flash_attention_plain(q, k, v, window=70)
    b = tfa.flash_attention_plain(q, k, v, window=70, block_kv=128)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("group", [1, 3])
def test_plain_version_takes_non_contiguous_inputs(group):
    """A transposed (non-contiguous) fp32 q, k and v, as a caller's head
    transpose leaves them, give on the CPU route exactly what their
    contiguous copies give."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 40, 40, 32, seed=5))
    k, v = k[::group], v[::group]
    qt, kt, vt = (x.transpose(0, 1).contiguous().transpose(0, 1)
                  for x in (q, k, v))
    assert not qt.is_contiguous()
    with torch.no_grad():
        a = tops.flash_attention(qt, kt, vt)
    b = tfa.flash_attention_plain(q, k, v)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dh", [8, 40, 272])
def test_wrapper_rejects_unsupported_head_dims(dh):
    x = torch.zeros(1, 4, dh)
    with pytest.raises(ValueError, match="multiple of 16"):
        tfa.flash_attention(x, x, x)


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3,
    (torch.float64,) * 3,
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16),
])
def test_wrapper_rejects_unsupported_dtypes(dtypes):
    q, k, v = (torch.zeros(1, 4, 32, dtype=d) for d in dtypes)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q, k, v)


def test_wrapper_rejects_bad_shapes_and_windows():
    q = torch.zeros(2, 4, 32)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention(q, torch.zeros(3, 4, 32), torch.zeros(3, 4, 32))
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention(q, torch.zeros(2, 5, 32), torch.zeros(2, 6, 32))
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, q, q, window=-1)


def test_cpu_calls_launch_nothing():
    before = tfa.LAUNCHES
    x = torch.randn(1, 8, 16)
    tfa.flash_attention(x, x, x)
    assert tfa.LAUNCHES == before
