"""The port's flash attention (``coinstac_dinunet_tpu_torch.ops.
flash_attention``) against the JAX package's, on the same numpy inputs.

On the CPU the port runs its plain versions; the JAX side runs
``impl="xla"`` and its Pallas kernels under the interpreter
(``impl="pallas_interpret"``), as ``tests/test_attention.py`` does, whose
cases these mirror.  Tolerances: outputs and lse within 1e-5 of the XLA
path and 1e-4 of the interpreted kernel (float32 sums in another order and
blockwise online-softmax rescaling); gradients within 2e-4 + 1e-3·|g|, the
JAX package's own bound between its two backward paths.  The card's
kernels are held against the plain versions by
``tests/test_torch_attention_card.py`` (skipped without a card) and by
``chip_smoke.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops import flash_attention as jax_flash
from coinstac_dinunet_tpu_torch.ops import flash_attention

# the module (the package exports its function under the same name)
fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


def _qkv(seed, b=2, h=2, t=64, d=32, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(dtype) for _ in range(3)]


def _port(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _jax_grads(arrays, impl, lse_term=False, **kw):
    def loss(q, k, v):
        out, lse = jax_flash(q, k, v, impl=impl, return_lse=True, **kw)
        extra = jnp.sum(jnp.sin(lse)) if lse_term else 0.0
        return jnp.sum(out.astype(jnp.float32) ** 2) + extra

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))]


def _port_grads(arrays, lse_term=False, **kw):
    q, k, v = _port(arrays, grad=True)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    loss = (out.float() ** 2).sum() + (torch.sin(lse).sum() if lse_term else 0.0)
    loss.backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("impl,atol", [("xla", 1e-5), ("pallas_interpret", 1e-4)])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal, impl, atol):
    # t=160 is not a multiple of the TPU kernel's 128-row blocks
    arrays = _qkv(1, b=1, h=2, t=160, d=32)
    want, want_lse = jax_flash(*map(jnp.asarray, arrays), causal=causal, impl=impl,
                               return_lse=True)
    with torch.no_grad():
        got, got_lse = flash_attention(*_port(arrays), causal=causal, return_lse=True)
    assert got.dtype == torch.float32 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=atol)


def test_grads_match_jax_causal():
    arrays = _qkv(2, b=1, h=1, t=48, d=16)
    for a, b in zip(_port_grads(arrays, causal=True), _jax_grads(arrays, "xla", causal=True)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax_kernel_backward(causal):
    """The TPU backward kernels (dq streaming keys, dk/dv streaming
    queries) under the interpreter, at a T that is not a tile multiple."""
    arrays = _qkv(7, b=1, h=2, t=160, d=32)
    want = _jax_grads(arrays, "pallas_interpret", causal=causal)
    for a, b in zip(_port_grads(arrays, causal=causal), want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_lse_cotangent_matches_jax():
    """``ds = p·(dp − Δ + g_lse)``: the lse output's cotangent reaches the
    inputs as in the JAX package's backward kernels."""
    arrays = _qkv(8, b=1, h=1, t=128, d=32)
    want = _jax_grads(arrays, "pallas_interpret", lse_term=True)
    for a, b in zip(_port_grads(arrays, lse_term=True), want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_kv_len_grads_match_jax_with_zero_tail():
    arrays = _qkv(9, b=1, h=1, t=128, d=32)
    got = _port_grads(arrays, kv_len=96)
    for a, b in zip(got, _jax_grads(arrays, "pallas_interpret", kv_len=96)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    # keys past kv_len receive exactly zero gradient
    assert np.abs(got[1][:, :, 96:]).max() == 0.0
    assert np.abs(got[2][:, :, 96:]).max() == 0.0


def test_kv_len_masks_tail_like_jax():
    arrays = _qkv(3, b=1, h=1, t=32, d=16)
    want = jax_flash(*map(jnp.asarray, arrays), kv_len=20, impl="xla")
    with torch.no_grad():
        got = flash_attention(*_port(arrays), kv_len=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_kv_len_past_tk_is_tk_like_jax_xla():
    """A ``kv_len`` past Tk masks nothing more: the port follows the JAX
    package's XLA path.  (Its Pallas path would count its zero-padded keys
    as valid — a difference between the reference's own two paths that the
    port does not carry.)"""
    arrays = _qkv(11, b=1, h=1, t=40, d=16)
    want = jax_flash(*map(jnp.asarray, arrays), kv_len=100, impl="xla")
    with torch.no_grad():
        got = flash_attention(*_port(arrays), kv_len=100)
        same = flash_attention(*_port(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got, same)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_fully_masked_rows_emit_zeros_like_jax(impl):
    arrays = _qkv(6, b=1, h=1, t=16, d=16)
    # kv_len=0 masks every key: all rows exactly zero, lse keeps the sentinel
    with torch.no_grad():
        out, lse = flash_attention(*_port(arrays), kv_len=0, return_lse=True)
    j_out, j_lse = jax_flash(*map(jnp.asarray, arrays), kv_len=0, impl=impl,
                             return_lse=True)
    assert np.all(out.numpy() == 0.0) and np.all(np.asarray(j_out) == 0.0)
    assert np.all(lse.numpy() < -1e29) and np.all(np.asarray(j_lse) < -1e29)
    # q_offset before every causal key: the same for a causal slice
    with torch.no_grad():
        out2 = flash_attention(*_port(arrays), causal=True, q_offset=0, k_offset=64)
    assert np.all(out2.numpy() == 0.0)
    # and the gradients through such rows are exactly zero, not NaN
    grads = _port_grads(arrays, kv_len=0, lse_term=True)
    assert all(np.all(g == 0.0) for g in grads)


def test_bf16_inputs_match_jax():
    """bfloat16 q/k/v: the same bf16 values enter both packages, the
    softmax runs in float32, out comes back in bfloat16 (one bf16 rounding:
    2^-8 relative) and lse in float32."""
    arrays = [jnp.asarray(a, jnp.bfloat16) for a in _qkv(4, b=1, h=2, t=96, d=32)]
    want, want_lse = jax_flash(*arrays, causal=True, impl="xla", return_lse=True)
    ported = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
              for a in arrays]
    with torch.no_grad():
        got, got_lse = flash_attention(*ported, causal=True, return_lse=True)
    assert got.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=1e-5)
    # gradients come back in the inputs' dtype
    q, k, v = [t.clone().requires_grad_() for t in ported]
    flash_attention(q, k, v).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_plain_versions_ignore_autocast():
    """Under the trainer's bf16 autocast the plain versions still compute
    in float32: the results equal those without autocast bit for bit."""
    q, k, v = _port(_qkv(5, b=1, h=2, t=40, d=16))
    want = fa.flash_forward_plain(q[0], k[0], v[0], 0, 0, 40, True, 0.25)
    with torch.autocast(device_type="cpu", dtype=torch.bfloat16):
        got = fa.flash_forward_plain(q[0], k[0], v[0], 0, 0, 40, True, 0.25)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_none_lse_cotangent_is_zeros():
    """A loss on ``out`` alone hands the backward no lse cotangent (the
    Function does not materialize it): it is taken as zeros."""
    q, k, v = [t[0].requires_grad_() for t in _port(_qkv(10, b=1, h=1, t=24, d=16))]
    out, lse = fa.FlashAttention.apply(q, k, v, 0, 0, 24, False, 0.25)
    g_out = torch.ones_like(out)
    got = torch.autograd.grad(out, (q, k, v), g_out)
    want = fa.flash_backward_plain(q, k, v, out, lse, g_out, torch.zeros_like(lse),
                                   0, 0, 24, False, 0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
