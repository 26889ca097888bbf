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


# --- the plain backward with the tensor-core kernels' roundings -----------
# K3 and K4 on bfloat16 inputs round g_out, p and ds to bfloat16 before
# their products and apply ``scale`` to the float32 products;
# ``round_dtype`` gives the plain backward the same roundings, for the
# checks on the card.  On the CPU it is held to the unrounded plain
# backward and to the JAX package's backward on the same bf16 inputs.

BACKWARD_CASES = {  # causal, q_offset, k_offset, kv_len, g_lse nonzero
    "causal": (True, 0, 0, 96, False),
    "kv_len_tail": (False, 0, 0, 60, False),
    "offsets": (True, 40, 13, 96, False),
    "g_lse": (False, 0, 0, 96, True),
    "causal_offsets_g_lse": (True, 40, 13, 80, True),
}


def _plain_backward_unrounded(q, k, v, g_out, lse, delta, g_lse, q_offset, k_offset, kv_len,
                           causal, scale):
    """The dense float32 backward written out on its own: ``scale`` folded
    into q, no rounding."""
    valid = fa._valid_mask(q.shape[1], k.shape[1], q_offset, k_offset, kv_len, causal, q.device)
    lse_safe = torch.where(lse <= fa._MASKED_LSE, 0.0, lse.float())
    qf = q.float() * scale
    kf, vf, go = k.float(), v.float(), g_out.float()
    s = torch.matmul(qf, kf.transpose(1, 2))
    p = torch.where(valid, torch.exp(torch.where(valid, s, fa._NEG) - lse_safe.unsqueeze(-1)), 0.0)
    dp = torch.matmul(go, vf.transpose(1, 2))
    ds = p * (dp - delta.float().unsqueeze(-1) + g_lse.float().unsqueeze(-1))
    return (torch.matmul(ds, kf) * scale, torch.matmul(ds.transpose(1, 2), qf),
            torch.matmul(p.transpose(1, 2), go))


def _backward_inputs(seed, case, dtype, bh=3, t=96, d=32, g_dtype=torch.float32):
    causal, qo, ko, kv, nz = BACKWARD_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.normal(size=(bh, t, d)).astype(np.float32)).to(dtype)
               for _ in range(3)]
    g_out = torch.from_numpy(rng.normal(size=(bh, t, d)).astype(np.float32))
    g_out = g_out.to(g_dtype).float()  # float32 values that g_dtype can carry
    g_lse = torch.from_numpy(rng.normal(size=(bh, t)).astype(np.float32)) * float(nz)
    pos = (qo, ko, kv, causal, d ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, *pos)
    return (q, k, v, g_out, lse, fa.flash_delta(out, g_out), g_lse, *pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_plain_backward_without_rounding_is_unchanged_bit_for_bit(case, dtype):
    args = _backward_inputs(21, case, dtype)
    for got, want in zip(fa._backward_plain(*args, round_dtype=None),
                         _plain_backward_unrounded(*args)):
        assert torch.equal(got, want)
    assert torch.equal(fa.flash_dq_plain(*args), fa._backward_plain(*args)[0])


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_scale_after_the_product_equals_scale_folded_into_q(case):
    """With float32 as the rounding dtype nothing is rounded, so the only
    difference is where ``scale`` multiplies: the float32 products (as in
    the tensor-core kernels) or q.  Within float32 rounding: 1e-5·max."""
    args = _backward_inputs(22, case, torch.bfloat16)
    for got, want in zip(fa._backward_plain(*args, round_dtype=torch.float32),
                         fa._backward_plain(*args)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_rounding_matched_plain_backward_matches_jax_in_bf16(case, impl):
    """The plain backward with the kernels' bfloat16 roundings against the
    JAX package's backward (``jax.vjp`` of its XLA path and of its Pallas
    kernels under the interpreter) on the same numpy-made bfloat16 inputs
    and cotangents: within 2e-2·max|jax| (bfloat16 carries 8 bits; the JAX
    gradients come back rounded to bfloat16 themselves)."""
    causal, qo, ko, kv, nz = BACKWARD_CASES[case]
    # g_out in values bfloat16 carries: the cotangent of a bfloat16 output
    args = _backward_inputs(23, case, torch.bfloat16, g_dtype=torch.bfloat16)
    q, k, v, g_out, _, _, g_lse = args[:7]
    # (BH, T, d) -> the JAX layout (B, H, T, d) with B = 1
    as_jax = lambda x, dt: jnp.asarray(x.float().numpy()[None], dt)
    qj, kj, vj = [as_jax(x, jnp.bfloat16) for x in (q, k, v)]
    (_, _), vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, q_offset=qo, k_offset=ko, kv_len=kv, causal=causal,
                                  impl=impl, return_lse=True), qj, kj, vj)
    want = vjp((as_jax(g_out, jnp.bfloat16), as_jax(g_lse, jnp.float32)))
    got = fa._backward_plain(*args, round_dtype=torch.bfloat16)
    for a, b in zip(got, want):
        b = np.asarray(b.astype(jnp.float32))[0]
        assert np.abs(a.numpy() - b).max() <= 2e-2 * np.abs(b).max()
    # and the rounding stays near the unrounded statement of the function
    for a, b in zip(got, fa._backward_plain(*args)):
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


# --- the plain forward with the tensor-core kernel's roundings ------------
# K2 on bfloat16 inputs scales the float32 product (log2 e folded in), runs
# its softmax online over key tiles of FWD_KEY_TILE and rounds p to
# bfloat16 against the running max before P·V; ``round_dtype`` gives the
# plain forward the same arithmetic, for the checks on the card.  On the CPU
# it is held to the unrounded plain forward, to the kernel's loop written
# out, and to the JAX package's forward on the same bf16 inputs.

FORWARD_T = 300  # three key tiles of 128: the running max moves


def _plain_forward_unrounded(q, k, v, q_offset, k_offset, kv_len, causal, scale):
    """The dense float32 forward written out on its own: ``scale`` folded
    into q, no rounding."""
    valid = fa._valid_mask(q.shape[1], k.shape[1], q_offset, k_offset, kv_len, causal, q.device)
    s = torch.where(valid, torch.matmul(q.float() * scale, k.float().transpose(1, 2)), fa._NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m.unsqueeze(-1))
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    out = torch.matmul(p / l.unsqueeze(-1), v.float())
    return torch.where((m > fa._MASKED_LSE).unsqueeze(-1), out, 0.0), m + torch.log(l)


def _online_loop(q, k, v, q_offset, k_offset, kv_len, causal, scale, round_dtype):
    """K2's loop on the bfloat16 path, tile by tile: the running max m, the
    rescale alpha of l and of the accumulator, p rounded before P·V."""
    tk, n = k.shape[1], fa.FWD_KEY_TILE
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
    l = torch.clamp_min(l, 1e-30)
    return (torch.where(ok.unsqueeze(-1), acc / l.unsqueeze(-1), 0.0),
            torch.where(ok, m * fa._LN2 + torch.log(l), fa._NEG))


def _forward_inputs(seed, case, dtype=torch.bfloat16, bh=3, t=FORWARD_T, d=32):
    causal, qo, ko, kv, _ = BACKWARD_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.normal(size=(bh, t, d)).astype(np.float32)).to(dtype)
               for _ in range(3)]
    return q, k, v, qo, ko, kv * t // 96, causal, d ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_plain_forward_without_rounding_is_unchanged_bit_for_bit(case, dtype):
    args = _forward_inputs(31, case, dtype)
    for got, want in zip(fa.flash_forward_plain(*args, round_dtype=None),
                         _plain_forward_unrounded(*args)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_forward_scale_after_the_product_equals_scale_folded_into_q(case):
    """With float32 as the rounding dtype nothing is rounded, so what is
    left is float32 rounding: where ``scale`` multiplies (the float32
    product, in log2 units, or q), exp2 against exp, and the running max's
    rescaling.  lse within 1e-6·max|lse|; out within 1e-6·max|v|: a row of
    out is a convex combination of the rows of v, so its rounding errors
    scale with v, not with the sums' cancellations (1.3e-6·max|out| seen)."""
    args = _forward_inputs(32, case)
    (out, lse), (want, want_lse) = (fa.flash_forward_plain(*args, round_dtype=torch.float32),
                                    fa.flash_forward_plain(*args))
    assert float((out - want).abs().max()) <= 1e-6 * float(args[2].float().abs().max())
    assert float((lse - want_lse).abs().max()) <= 1e-6 * float(want_lse.abs().max())


@pytest.mark.parametrize("case", list(BACKWARD_CASES) + ["all_masked"])
def test_rounding_matched_plain_forward_is_the_kernels_loop(case):
    """The dense rounding-matched forward against K2's tile loop written
    out: the same roundings, float32 sums in another order (1e-5·max); a
    fully masked row keeps lse = −1e30 exactly."""
    if case == "all_masked":
        args = _forward_inputs(33, "causal")[:3] + (0, FORWARD_T, FORWARD_T, True, 32 ** -0.5)
    else:
        args = _forward_inputs(33, case)
    got = fa.flash_forward_plain(*args, round_dtype=torch.bfloat16)
    want = _online_loop(*args, round_dtype=torch.bfloat16)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-7
    if case == "all_masked":
        assert torch.all(got[0] == 0) and torch.all(got[1] == fa._NEG)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_rounding_matched_plain_forward_matches_jax_in_bf16(case, impl):
    """The plain forward with the kernel's bfloat16 roundings against the
    JAX package's forward (its XLA path and its Pallas kernel under the
    interpreter) on the same numpy-made bfloat16 inputs: out within
    2e-2·max|jax| (bfloat16 carries 8 bits; the JAX output comes back in
    bfloat16 itself), lse within 1e-4·max|lse| + 1e-5."""
    q, k, v, qo, ko, kv, causal, scale = _forward_inputs(34, case)
    as_jax = lambda x: jnp.asarray(x.float().numpy()[None], jnp.bfloat16)
    want, want_lse = jax_flash(as_jax(q), as_jax(k), as_jax(v), q_offset=qo, k_offset=ko,
                               kv_len=kv, causal=causal, impl=impl, return_lse=True)
    want = np.asarray(want.astype(jnp.float32))[0]
    want_lse = np.asarray(want_lse)[0]
    got, got_lse = fa.flash_forward_plain(q, k, v, qo, ko, kv, causal, scale,
                                          round_dtype=torch.bfloat16)
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()
    assert np.abs(got_lse.numpy() - want_lse).max() <= 1e-4 * np.abs(want_lse).max() + 1e-5
    # and the rounding stays near the unrounded statement of the function
    plain = fa.flash_forward_plain(q, k, v, qo, ko, kv, causal, scale)[0]
    assert float((got - plain).abs().max()) <= 2e-2 * float(plain.abs().max())


@pytest.mark.parametrize("impl,atol", [("xla", 1e-5), ("pallas_interpret", 1e-4)])
def test_head_dim_16_matches_jax(impl, atol):
    """The sequence example's head dim (d_model 64 over 4 heads, T 128):
    the port's output, lse and gradients against the JAX package's, whose
    TPU kernel takes any last dim; the card's kernels take 16 as well
    (``HEAD_DIMS``)."""
    assert 16 in fa.HEAD_DIMS
    arrays = _qkv(16, b=2, h=4, t=128, d=16)
    want, want_lse = jax_flash(*map(jnp.asarray, arrays), impl=impl, return_lse=True)
    with torch.no_grad():
        got, got_lse = flash_attention(*_port(arrays), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=atol)
    for a, b in zip(_port_grads(arrays, lse_term=True),
                    _jax_grads(arrays, impl, lse_term=True)):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
