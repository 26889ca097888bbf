"""K2–K4's wrapper contract at head dims the kernels are not instantiated
for (4, 8 and 24, and 160, 256 and 320 above the largest), against the JAX
package's ``flash_attention``.

On the card the wrapper zero-pads ``q``, ``k``, ``v`` and ``g_out`` in the
head dim to the next instantiated dim (``padded_head_dim``), passes the
true head dim's scale and slices ``out``, ``dq``, ``dk`` and ``dv`` back.
Here, on the CPU, the same padding goes through the plain versions (the
kernels' function): padded and sliced, they must equal the JAX package's
attention at the true head dim, as must the port's ``flash_attention``
itself.  The kernels are held against the plain versions on the card by
``chip_smoke.py`` phase 3.  Tolerances: outputs and lse within 1e-5 of the
XLA path and 1e-4 of the interpreted Pallas kernel, gradients within 2e-4
+ 1e-3·|g| (``tests/test_torch_attention.py``'s bounds).

Above 128 the card runs the sliced kernels at the head dim itself, no
padding, in float32 whatever the input type: their plain version is the
float32 one, ``round_dtype`` changes nothing there, and the port's
function must equal JAX within the same bounds, over the offset,
``kv_len`` and causal masks and a T that is no tile multiple.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops import flash_attention as jax_flash
from coinstac_dinunet_tpu_torch.ops import flash_attention

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
HEAD_DIMS = (4, 8, 24)
WIDE_HEAD_DIMS = (160, 256, 320)
# (q_offset, k_offset, kv_len or None, causal); T 100 is no tile multiple
WIDE_MASKS = [(0, 0, None, False), (0, 0, None, True), (30, 7, 90, True)]
IMPLS = [("xla", 1e-5), ("pallas_interpret", 1e-4)]


def _qkv(seed, d, b=1, h=2, t=160):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3)]


def _jax_loss_grads(arrays, impl, causal):
    def loss(q, k, v):
        out, lse = jax_flash(q, k, v, impl=impl, causal=causal, return_lse=True)
        return jnp.sum(out.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(lse))

    return [np.asarray(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))]


def test_padded_head_dim_maps_every_dim_to_an_instantiated_one():
    for d in range(1, 129):
        dim = fa.padded_head_dim(d)
        assert dim in fa.HEAD_DIMS and dim >= d
        assert all(h < d for h in fa.HEAD_DIMS if h < dim)
    for d in (129, 160, 256, 320, 1000):  # the sliced kernels: no padding
        assert fa.padded_head_dim(d) == d
    with pytest.raises(ValueError, match="head dims of 1 or more"):
        fa.padded_head_dim(0)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_pad_head_dim_appends_zero_columns(d):
    t = torch.randn(3, 5, d)
    dim = fa.padded_head_dim(d)
    padded = fa._pad_head_dim(t, dim)
    assert padded.shape == (3, 5, dim) and padded.is_contiguous()
    assert torch.equal(padded[..., :d], t) and not padded[..., d:].any()


@pytest.mark.parametrize("impl,atol", IMPLS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_plain_forward_matches_jax(d, causal, impl, atol):
    """The forward the card computes — zero-padded inputs, the true head
    dim's scale, the output sliced back — against JAX at head dim ``d``."""
    arrays = _qkv(d, d)
    want, want_lse = jax_flash(*map(jnp.asarray, arrays), causal=causal, impl=impl,
                               return_lse=True)
    b, h, t, _ = arrays[0].shape
    dim = fa.padded_head_dim(d)
    q, k, v = (fa._pad_head_dim(torch.from_numpy(a).reshape(b * h, t, d), dim)
               for a in arrays)
    out, lse = fa.flash_forward_plain(q, k, v, 0, 0, t, causal, d ** -0.5)
    np.testing.assert_allclose(out[..., :d].reshape(b, h, t, d).numpy(), np.asarray(want),
                               atol=atol)
    np.testing.assert_allclose(lse.reshape(b, h, t).numpy(), np.asarray(want_lse), atol=atol)
    with torch.no_grad():  # and the port's own function at head dim d
        got, got_lse = flash_attention(*map(torch.from_numpy, arrays), causal=causal,
                                       return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=atol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_padded_plain_backward_matches_jax(d, causal):
    """The backward the card computes — q, k, v and g_out zero-padded, dq,
    dk and dv sliced back — against JAX's gradients at head dim ``d``, with
    a cotangent on the lse as well."""
    arrays = _qkv(100 + d, d)
    want = _jax_loss_grads(arrays, "xla", causal)
    b, h, t, _ = arrays[0].shape
    dim = fa.padded_head_dim(d)
    q, k, v = (torch.from_numpy(a).reshape(b * h, t, d) for a in arrays)
    scale = d ** -0.5
    out, lse = fa.flash_forward_plain(q, k, v, 0, 0, t, causal, scale)
    g_out, g_lse = 2 * out, torch.cos(lse)  # d/d(out) of Σ out², d/d(lse) of Σ sin(lse)
    padded = [fa._pad_head_dim(x, dim) for x in (q, k, v)]
    got = fa.flash_backward_plain(*padded, fa._pad_head_dim(out, dim), lse,
                                  fa._pad_head_dim(g_out, dim), g_lse, 0, 0, t, causal, scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[..., :d].reshape(b, h, t, d).numpy(), w, **GRAD_TOL)
    # the padded columns' gradients are zero: dropping them loses nothing
    assert not got[0][..., d:].any()
    # and the port's autograd path at head dim d
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_() for a in arrays)
    o, l = flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    ((o.float() ** 2).sum() + torch.sin(l).sum()).backward()
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("impl,atol", IMPLS)
@pytest.mark.parametrize("mask", WIDE_MASKS)
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_plain_forward_matches_jax(d, mask, impl, atol):
    """Above 128: the port's function against JAX at head dim ``d``, masks
    included."""
    q_offset, k_offset, kv_len, causal = mask
    arrays = _qkv(d, d, t=100)
    b, h, t, _ = arrays[0].shape
    pos = dict(q_offset=q_offset, k_offset=k_offset, kv_len=kv_len, causal=causal)
    want, want_lse = jax_flash(*map(jnp.asarray, arrays), impl=impl, return_lse=True, **pos)
    want, want_lse = np.asarray(want), np.asarray(want_lse)
    with torch.no_grad():
        got, got_lse = flash_attention(*map(torch.from_numpy, arrays), return_lse=True, **pos)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=atol)


@pytest.mark.parametrize("mask", WIDE_MASKS)
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_plain_backward_matches_jax(d, mask):
    """Above 128: the port's autograd path (the plain backward the sliced
    K3 and K4 are held to on the card) against JAX's gradients at head dim
    ``d``, with a cotangent on the lse as well, masks included."""
    q_offset, k_offset, kv_len, causal = mask
    arrays = _qkv(100 + d, d, t=100)
    pos = dict(q_offset=q_offset, k_offset=k_offset, kv_len=kv_len, causal=causal)

    def loss(q, k, v):
        out, lse = jax_flash(q, k, v, impl="xla", return_lse=True, **pos)
        return jnp.sum(out.astype(jnp.float32) ** 2) + jnp.sum(jnp.sin(lse))

    want = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))]
    qt, kt, vt = (torch.from_numpy(a.copy()).requires_grad_() for a in arrays)
    o, l = flash_attention(qt, kt, vt, return_lse=True, **pos)
    ((o.float() ** 2).sum() + torch.sin(l).sum()).backward()
    for g, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_plain_versions_ignore_round_dtype(d):
    """The sliced kernels round nothing to bfloat16 (no tensor core takes
    a bfloat16 operand there), so above 128 the rounding-matched plain
    versions the card checks them against are the float32 ones, bit for
    bit, forward and backward."""
    arrays = _qkv(200 + d, d, t=100)
    q, k, v = (torch.from_numpy(a).reshape(2, 100, d).to(torch.bfloat16) for a in arrays)
    pos = (0, 0, 100, True, d ** -0.5)
    exact = fa.flash_forward_plain(q, k, v, *pos)
    matched = fa.flash_forward_plain(q, k, v, *pos, round_dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(exact, matched))
    g_out = torch.from_numpy(_qkv(300 + d, d, t=100)[0]).reshape(2, 100, d)
    args = (q, k, v, g_out, exact[1], fa.flash_delta(exact[0], g_out),
            torch.zeros(2, 100), *pos)
    assert torch.equal(fa.flash_dq_plain(*args), fa.flash_dq_plain(*args, round_dtype=torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_dkv_plain(*args), fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16)))
