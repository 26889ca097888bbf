"""K2–K4's wrapper contract at head dims the kernels are not instantiated
for (4, 8 and 24, and 160, 256, 320, 384, 448, 512 and 576 above the
largest), against the JAX package's ``flash_attention``.

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

Above 128, bfloat16 K2, K3 and K4 run on the tensor cores at the head dim
zero-padded to 192, 256, 320, 384 or 512 (``wide_head_dim``), with the
roundings of the kernels below it (``p`` and ``ds`` in bfloat16, the
forward's online softmax over key tiles of 64, or 32 at 384 and 512), and
so do the float32 K2, K3 and K4 (three TF32 products a float32 product, no
rounding); every head dim above 512 runs on the sliced kernels at the head
dim itself, which on bfloat16 inputs round the same values (the forward's
running max over key tiles of 64).
So the rounding-matched plain forward, dq and dk/dv round at every head
dim (held to the JAX package's bfloat16 attention within 2e-2·max, the
format's error, as below 128), and the unrounded plain versions equal JAX
within the bounds above, over the offset, ``kv_len`` and causal masks and a
T that is no tile multiple.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops import flash_attention as jax_flash
from coinstac_dinunet_tpu_torch.ops import flash_attention
from _torch_threads import few_torch_threads  # noqa: F401  (autouse)

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)
HEAD_DIMS = (4, 8, 24)
WIDE_HEAD_DIMS = (160, 256, 320)
# (q_offset, k_offset, kv_len or None, causal); T 100 is no tile multiple
WIDE_MASKS = [(0, 0, None, False), (0, 0, None, True), (30, 7, 90, True)]
# (d, mask) of the bfloat16 rounding-matched plain versions held to JAX:
# every mask up to 320; at 384, 448 (padded to 512) and 512 (K2, K4 on the
# tensor cores, K3 sliced) and 576 (all three sliced) the offsets, kv_len and
# causal mask alone, which takes every path the other two take (each case
# at a new head dim compiles JAX anew, a second or more)
BF16_CASES = [pytest.param(d, mask, id=f"{d}-mask{i}")
              for d in (*WIDE_HEAD_DIMS, 384, 448, 512, 576)
              for i, mask in enumerate(WIDE_MASKS) if d <= 320 or i == 2]
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
    for d in (129, 160, 256, 320, 1000):  # K3 and float32: the sliced kernels, no padding
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


@pytest.mark.parametrize("d", (*WIDE_HEAD_DIMS, 384))
def test_wide_plain_versions_ignore_round_dtype(d):
    """No plain version ignores ``round_dtype`` any more: K2, K3 and K4 on
    bfloat16 inputs round as the TPU does at every head dim, on the tensor
    cores and on the sliced kernels (above 320 for K3, above 512 for all
    three), so every rounding-matched plain version differs from the
    float32 one (at 384: K3 sliced); one call for dq and dk/dv gives what
    two calls give."""
    arrays = _qkv(200 + d, d, t=100)
    q, k, v = (torch.from_numpy(a).reshape(2, 100, d).to(torch.bfloat16) for a in arrays)
    pos = (0, 0, 100, True, d ** -0.5)
    assert fa.rounds_at(d, dq=True) and fa.rounds_at(d)
    exact = fa.flash_forward_plain(q, k, v, *pos)
    matched = fa.flash_forward_plain(q, k, v, *pos, round_dtype=torch.bfloat16)
    assert not torch.equal(exact[0], matched[0])
    g_out = torch.from_numpy(_qkv(300 + d, d, t=100)[0]).reshape(2, 100, d)
    args = (q, k, v, g_out, exact[1], fa.flash_delta(exact[0], g_out),
            torch.zeros(2, 100), *pos)
    dq = fa.flash_dq_plain(*args, round_dtype=torch.bfloat16)
    assert not torch.equal(dq, fa.flash_dq_plain(*args))
    both = fa._backward_plain(*args, round_dtype=torch.bfloat16)
    assert torch.equal(both[0], dq)
    dkv = fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(both[1:], dkv))
    exact_dkv = fa.flash_dkv_plain(*args)
    assert not any(torch.equal(a, b) for a, b in zip(dkv, exact_dkv))


def test_wide_head_dim_maps_bf16_k2_k4_to_the_tensor_core_dims():
    """K2, K3 and K4 from 129 to 512, bfloat16 and float32, run at the next
    of 192, 256, 320, 384 and 512 (``_kernel_head_dim``); every kernel above
    512 at the head dim itself (the sliced kernels); up to 128 every kernel at
    ``padded_head_dim``.  Every bfloat16 kernel rounds (``rounds_at``), and
    the key tiles are those of the kernel that runs the head dim."""
    for d in range(129, 513):
        dim = fa.wide_head_dim(d)
        assert dim in fa.WIDE_HEAD_DIMS and dim >= d and dim - d < 128
        assert all(w < d for w in fa.WIDE_HEAD_DIMS if w < dim)
        assert fa._kernel_head_dim(d, torch.bfloat16) == dim
        assert fa._kernel_head_dim(d, torch.float32) == dim
        for kernel in (fa.DQ_KERNEL, fa.DKV_KERNEL):
            assert fa._kernel_head_dim(d, torch.bfloat16, kernel) == dim
            assert fa._kernel_head_dim(d, torch.float32, kernel) == dim
        assert fa.rounds_at(d, dq=True)
    for d in (513, 576, 1000):
        assert fa.wide_head_dim(d) is None
        assert fa._kernel_head_dim(d, torch.bfloat16) == d
        assert fa._kernel_head_dim(d, torch.float32) == d
    for d in (1, 24, 100, 128):
        assert fa.wide_head_dim(d) is None
        assert fa._kernel_head_dim(d, torch.bfloat16) == fa.padded_head_dim(d)
    assert fa.rounds_at(320) and fa.rounds_at(321) and fa.rounds_at(576)
    assert fa.rounds_at(320, dq=True) and fa.rounds_at(321, dq=True)
    assert [fa.fwd_key_tile(d) for d in (128, 129, 320, 321, 448, 512, 513)] == [
        128, 64, 64, 32, 32, 32, 64]
    assert [fa.dq_key_tile(d) for d in (128, 192, 193, 320, 321, 384, 385, 512, 576)] == [
        64, 64, 32, 32, 32, 32, 16, 16, 64]


def _online_tiles(q, k, v, pos, n, round_dtype):
    """The wide K2's loop written out, key tile by key tile: the running max
    m, the rescale of l and the accumulator, p rounded before P·V."""
    q_offset, k_offset, kv_len, causal, scale = pos
    tk = k.shape[1]
    valid = fa._valid_mask(q.shape[1], tk, q_offset, k_offset, kv_len, causal, q.device)
    t_all = torch.where(valid, (q.float() @ k.float().transpose(1, 2)) * (scale * fa._LOG2E),
                        fa._NEG)
    m = torch.full(q.shape[:2], fa._NEG)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros(q.shape)
    for c0 in range(0, tk, n):
        t = t_all[..., c0:c0 + n]
        m_new = torch.maximum(m, t.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new.unsqueeze(-1))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha.unsqueeze(-1) + p.to(round_dtype).float() @ v[:, c0:c0 + n].float()
        m = m_new
    ok = m > fa._MASKED_LSE
    return torch.where(ok.unsqueeze(-1), acc / torch.clamp_min(l, 1e-30).unsqueeze(-1), 0.0)


@pytest.mark.parametrize("mask", WIDE_MASKS)
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_rounding_matched_forward_takes_key_tiles_of_64(d, mask):
    """Above 128 the rounding-matched plain forward is the wide K2's loop
    over key tiles of 64 (``fwd_key_tile``): within float32 rounding of it
    (1e-5·max), and not the loop over tiles of 128."""
    q_offset, k_offset, kv_len, causal = mask
    arrays = _qkv(400 + d, d, t=300)
    q, k, v = (torch.from_numpy(a).reshape(2, 300, d).to(torch.bfloat16) for a in arrays)
    pos = (q_offset, k_offset, 300 if kv_len is None else kv_len * 3, causal, d ** -0.5)
    got = fa.flash_forward_plain(q, k, v, *pos, round_dtype=torch.bfloat16)[0]
    want = _online_tiles(q, k, v, pos, 64, torch.bfloat16)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float((got - _online_tiles(q, k, v, pos, 128, torch.bfloat16)).abs().max()) > tol


@pytest.mark.parametrize("d,tile,other", [(448, 32, 64), (576, 64, 32)])
def test_rounding_matched_forward_takes_the_kernels_key_tiles_above_320(d, tile, other):
    """From 321 to 512 the tensor-core K2 advances its running max over key
    tiles of 32, above 512 the sliced K2 over its tiles of 64: the
    rounding-matched plain forward is that loop, within float32 rounding
    of it (1e-5·max), and not the loop over the other tile."""
    arrays = _qkv(450 + d, d, t=200)
    q, k, v = (torch.from_numpy(a).reshape(2, 200, d).to(torch.bfloat16) for a in arrays)
    pos = (30, 7, 180, True, d ** -0.5)
    assert fa.fwd_key_tile(d) == tile
    got = fa.flash_forward_plain(q, k, v, *pos, round_dtype=torch.bfloat16)[0]
    want = _online_tiles(q, k, v, pos, tile, torch.bfloat16)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float((got - _online_tiles(q, k, v, pos, other, torch.bfloat16)).abs().max()) > tol


# bfloat16 carries 8 bits: the rounding-matched plain versions and the JAX
# package's bfloat16 attention each err by the format's error, so they are
# held to each other within 2e-2 of the largest magnitude, as below 128
# (tests/test_torch_attention.py)
BF16_FORMAT_RTOL = 2e-2


def _bf16_jax_inputs(seed, d, t=100):
    arrays = _qkv(seed, d, t=t)
    bf = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    return bf, [jnp.asarray(a, jnp.bfloat16) for a in bf]


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("d,mask", BF16_CASES)
def test_wide_rounding_matched_forward_matches_jax_in_bf16(d, mask, impl):
    """The rounding-matched plain K2 above 128 against the JAX package's
    forward on the same bfloat16 inputs, within BF16_FORMAT_RTOL·max."""
    q_offset, k_offset, kv_len, causal = mask
    bf, jx = _bf16_jax_inputs(500 + d, d)
    b, h, t, _ = bf[0].shape
    want = np.asarray(jax_flash(*jx, q_offset=q_offset, k_offset=k_offset, kv_len=kv_len,
                                causal=causal, impl=impl).astype(jnp.float32))
    q, k, v = (torch.from_numpy(a).reshape(b * h, t, d).to(torch.bfloat16) for a in bf)
    got = fa.flash_forward_plain(q, k, v, q_offset, k_offset, t if kv_len is None else kv_len,
                                 causal, d ** -0.5, round_dtype=torch.bfloat16)[0]
    got = got.reshape(b, h, t, d).numpy()
    assert np.abs(got - want).max() <= BF16_FORMAT_RTOL * np.abs(want).max()


@pytest.mark.parametrize("d,mask", BF16_CASES)
def test_wide_rounding_matched_dkv_matches_jax_in_bf16(d, mask):
    """The rounding-matched plain K4 above 128 (``g_out``, ``p`` and ``ds``
    in bfloat16) against the JAX package's dk and dv (``jax.vjp`` of its XLA
    path on the same bfloat16 inputs and cotangents), within
    BF16_FORMAT_RTOL·max."""
    q_offset, k_offset, kv_len, causal = mask
    bf, jx = _bf16_jax_inputs(600 + d, d)
    b, h, t, _ = bf[0].shape
    rng = np.random.default_rng(700 + d)
    g_out = np.array(jnp.asarray(rng.normal(size=(b, h, t, d)), jnp.bfloat16)
                     .astype(jnp.float32))
    g_lse = rng.normal(size=(b, h, t)).astype(np.float32)
    pos = dict(q_offset=q_offset, k_offset=k_offset, kv_len=kv_len, causal=causal)
    _, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, impl="xla", return_lse=True, **pos),
                     *jx)
    want = vjp((jnp.asarray(g_out, jnp.bfloat16), jnp.asarray(g_lse)))[1:]
    q, k, v = (torch.from_numpy(a).reshape(b * h, t, d).to(torch.bfloat16) for a in bf)
    ppos = (q_offset, k_offset, t if kv_len is None else kv_len, causal, d ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, *ppos)
    g = torch.from_numpy(g_out).reshape(b * h, t, d)
    args = (q, k, v, g, lse, fa.flash_delta(out, g), torch.from_numpy(g_lse).reshape(b * h, t),
            *ppos)
    for got, w in zip(fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16), want):
        w = np.asarray(w.astype(jnp.float32)).reshape(b * h, t, d)
        assert np.abs(got.numpy() - w).max() <= BF16_FORMAT_RTOL * np.abs(w).max()


@pytest.mark.parametrize("d,mask", BF16_CASES)
def test_wide_rounding_matched_dq_matches_jax_in_bf16(d, mask):
    """The rounding-matched plain K3 above 128 (``g_out`` and ``ds`` in
    bfloat16, as the tensor-core K3 rounds them) against the JAX package's
    dq (``jax.vjp`` of its XLA path on the same bfloat16 inputs and
    cotangents), within BF16_FORMAT_RTOL·max."""
    q_offset, k_offset, kv_len, causal = mask
    bf, jx = _bf16_jax_inputs(800 + d, d)
    b, h, t, _ = bf[0].shape
    rng = np.random.default_rng(900 + d)
    g_out = np.array(jnp.asarray(rng.normal(size=(b, h, t, d)), jnp.bfloat16)
                     .astype(jnp.float32))
    g_lse = rng.normal(size=(b, h, t)).astype(np.float32)
    pos = dict(q_offset=q_offset, k_offset=k_offset, kv_len=kv_len, causal=causal)
    _, vjp = jax.vjp(lambda a, c, e: jax_flash(a, c, e, impl="xla", return_lse=True, **pos),
                     *jx)
    want = np.asarray(vjp((jnp.asarray(g_out, jnp.bfloat16), jnp.asarray(g_lse)))[0]
                      .astype(jnp.float32)).reshape(b * h, t, d)
    q, k, v = (torch.from_numpy(a).reshape(b * h, t, d).to(torch.bfloat16) for a in bf)
    ppos = (q_offset, k_offset, t if kv_len is None else kv_len, causal, d ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, *ppos)
    g = torch.from_numpy(g_out).reshape(b * h, t, d)
    args = (q, k, v, g, lse, fa.flash_delta(out, g), torch.from_numpy(g_lse).reshape(b * h, t),
            *ppos)
    got = fa.flash_dq_plain(*args, round_dtype=torch.bfloat16)
    assert np.abs(got.numpy() - want).max() <= BF16_FORMAT_RTOL * np.abs(want).max()
