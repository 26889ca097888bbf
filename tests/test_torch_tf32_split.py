"""The float32 kernels' three-product TF32 split, emulated on the CPU.

The float32 K2 and K4 at every head dim up to 512, and K3 above 128
(``csrc/flash_attention_tf32.cuh``), compute every tile product (K2's
S = Q·Kᵀ and O += P·V; K3's S, dP = dO·Vᵀ and dq += dS·K; K4's Sᵀ, dPᵀ,
dk += dSᵀ·q and dv += Pᵀ·dO) on the tensor cores in TF32: each float32
operand x splits into big = x rounded to TF32 (10 significand bits, to
nearest with ties away from zero, as ``cvt.rna.tf32.f32``) and small = x − big
rounded the same way (K2) or cut to its top 10 significand bits (K3 and
K4, which hand it over unrounded), and a product is a_small·b_big +
a_big·b_small + a_big·b_big.  The kernel runs only on the card; here the same roundings,
done by bit operations on float32 views, go through a torch emulation of
the forward and of the backward (float32 sums, the plain version's masks),
and:

- the three-product forward and backward stay within FLASH_RTOL·max +
  FLASH_ATOL (the float32 gate of ``chip_smoke.py`` phase 3) of the
  function, with a margin of 10 or more (the backward against the
  function in float64 at phase 3's float32 cases, at head dims 16 to
  384), and equal the JAX package's float32 attention and its vjp within
  that gate, at head dims 16, 32, 64, 128 and 256;
- one TF32 product (big·big alone, the fault planted in the kernel)
  crosses the gate against the float32 plain version at ``offsets_d384``,
  the phase-3 case (B 1, H 2, T 333, d 384, causal, offsets 100 and 37,
  kv_len 300) where the fault is planted on the card: in K2's out, and in
  one of K3's and K4's dq, dk and dv; and at phase 3's float32 cases of
  128 and below, in K2's out and in one of K4's dk and dv.

Besides: which kernel runs which head dim (``_kernel_head_dim``,
``wide_head_dim``, ``dq_key_tile``, ``kernel_route``), and
``chip_smoke.flash_bound_ms`` at the timed shapes (float32 at the tensor
cores' TF32 rate over three).
"""
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops import flash_attention as jax_flash

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

RTOL, ATOL = 1e-4, 1e-6  # chip_smoke.FLASH_RTOL, FLASH_ATOL
MARGIN = 10.0
# (name, B, H, T, d, causal, q_offset, k_offset, kv_len) of phase 3
OFFSETS_D384 = ("offsets_d384", 1, 2, 333, 384, True, 100, 37, 300)
# phase 3's float32 cases above 128 that the backward is held at, with
# whether they take a nonzero lse cotangent
BWD_CASES = [
    (("offsets_d160", 1, 2, 333, 160, True, 100, 37, 300), True),
    (("kv_len_96_d256", 1, 1, 128, 256, False, 0, 0, 96), False),
    (("offsets_d320", 1, 2, 333, 320, True, 100, 37, 300), True),
    (OFFSETS_D384, True),
    # and up to 128, where K4 runs so (K3 there on the CUDA cores)
    (("offsets_d16", 1, 2, 333, 16, True, 100, 37, 300), True),
    (("kv_len_96", 1, 1, 128, 32, False, 0, 0, 96), False),
    (("offsets_d64", 1, 2, 333, 64, True, 100, 37, 300), True),
    (("t160_d128", 1, 2, 160, 128, False, 0, 0, 160), True),
    (("offsets_d128", 1, 2, 333, 128, True, 100, 37, 300), True),
]
# phase 3's float32 cases up to 128 at which the one-product fault is held
# to cross the gate (K2's out; one of K4's dk and dv)
SMALL_FAULT_CASES = [
    ("offsets_d16", 1, 2, 333, 16, True, 100, 37, 300),
    ("offsets_d24", 1, 2, 333, 24, True, 100, 37, 300),
    ("offsets_d64", 1, 2, 333, 64, True, 100, 37, 300),
    ("offsets_d128", 1, 2, 333, 128, True, 100, 37, 300),
]
CASES = [  # (name, B, H, T, d, causal, q_offset, k_offset, kv_len)
    ("t512_d256", 1, 2, 512, 256, False, 0, 0, 512),
    ("t333_d256_offsets", 1, 2, 333, 256, True, 100, 37, 300),
    ("t512_d384_causal", 1, 2, 512, 384, True, 0, 0, 512),
    OFFSETS_D384,
    # up to 128 (K2 at 16, 32, 64 and 128)
    ("t512_d16", 1, 2, 512, 16, False, 0, 0, 512),
    ("t333_d32_offsets", 1, 2, 333, 32, True, 100, 37, 300),
    ("t512_d64_causal", 1, 2, 512, 64, True, 0, 0, 512),
    ("t512_d128", 1, 2, 512, 128, False, 0, 0, 512),
]
# head dims of the JAX comparisons: 256 (the first, whose cases keep their
# ids) and those up to 128
JAX_CASES = [pytest.param(d, causal, id=str(causal) if d == 256 else f"d{d}-{causal}")
             for d in (256, 16, 32, 64, 128) for causal in (False, True)]


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: add half
    of the 13 dropped bits' weight to the magnitude, then drop them (ties
    away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncate_tf32(x):
    """float32 ``x`` cut to TF32: the 13 low significand bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x, round_small=True):
    """``(big, small)`` of float32 ``x``: ``x = big + small`` before
    ``small`` is rounded to TF32 (K2) or cut to it (``round_small=False``:
    K3 and K4 hand it over unrounded)."""
    big = to_tf32(x)
    return big, (to_tf32 if round_small else truncate_tf32)(x - big)


def products(a, b, n, round_small=True):
    """``a @ b`` of float32 operands on the tensor cores' TF32 split: three
    products (``n = 3``) or big·big alone (``n = 1``), float32 sums."""
    a_big, a_small = split(a, round_small)
    b_big, b_small = split(b, round_small)
    if n == 1:
        return a_big @ b_big
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulated_forward(q, k, v, pos, n=3):
    """The float32 K2 above 128 with its products split ``n`` ways: scores
    times ``scale``, the plain version's masks and sentinel, ``p`` against
    the row max in float32, ``out = (p·V) / l``, ``lse = m + log l``."""
    q_offset, k_offset, kv_len, causal, scale = pos
    valid = fa._valid_mask(q.shape[1], k.shape[1], q_offset, k_offset, kv_len, causal, "cpu")
    s = torch.where(valid, products(q, k.transpose(1, 2), n) * scale, fa._NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    ok = m > fa._MASKED_LSE
    out = torch.where(ok, products(p, v, n) / l, 0.0)
    return out, (m + torch.log(l)).squeeze(-1)


def emulated_backward(q, k, v, g_out, lse, delta, g_lse, pos, n=3):
    """The float32 K3 and K4 above 128 with their five products split ``n``
    ways, each small part cut to TF32: ``s`` the product times ``scale``, ``p = exp(s − lse)`` on valid
    keys (an lse at or below the masked sentinel taken as 0), ``ds = p·(dp −
    (Δ − g_lse))``, ``dq`` and ``dk`` the products times ``scale`` at the
    end, as the kernels compute them.  Returns ``(dq, dk, dv)``."""
    q_offset, k_offset, kv_len, causal, scale = pos
    valid = fa._valid_mask(q.shape[1], k.shape[1], q_offset, k_offset, kv_len, causal, "cpu")
    lse = torch.where(lse <= fa._MASKED_LSE, 0.0, lse).unsqueeze(-1)
    mm = lambda a, b: products(a, b, n, round_small=False)
    s = mm(q, k.transpose(1, 2)) * scale
    p = torch.where(valid, torch.exp(torch.where(valid, s, fa._NEG) - lse), 0.0)
    dp = mm(g_out, v.transpose(1, 2))
    ds = p * (dp - (delta - g_lse).unsqueeze(-1))
    return mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale, mm(p.transpose(1, 2), g_out)


def backward64(q, k, v, g_out, lse, delta, g_lse, pos):
    """K3's and K4's function in float64 on the same inputs (lse and Δ
    taken as given): ``(dq, dk, dv)``."""
    q_offset, k_offset, kv_len, causal, scale = pos
    q, k, v, g_out, lse, delta, g_lse = (t.double() for t in (q, k, v, g_out, lse, delta, g_lse))
    valid = fa._valid_mask(q.shape[1], k.shape[1], q_offset, k_offset, kv_len, causal, "cpu")
    lse = torch.where(lse <= fa._MASKED_LSE, 0.0, lse).unsqueeze(-1)
    qs = q * scale
    s = qs @ k.transpose(1, 2)
    p = torch.where(valid, torch.exp(torch.where(valid, s, fa._NEG) - lse), 0.0)
    ds = p * (g_out @ v.transpose(1, 2) - (delta - g_lse).unsqueeze(-1))
    return ds @ k * scale, ds.transpose(1, 2) @ qs, p.transpose(1, 2) @ g_out


def reference64(q, k, v, pos):
    """The function in float64."""
    out, lse = fa.flash_forward_plain(q.double(), k.double(), v.double(), *pos)
    return out, lse


def _inputs(case, seed):
    _, b, h, t, d, causal, qo, ko, kv = case
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b * h, t, d)).astype(np.float32))
               for _ in range(3))
    return q, k, v, (qo, ko, kv, causal, d ** -0.5)


def _backward_inputs(case, seed, nz_glse):
    """Phase 3's backward arguments at ``case``: q, k, v, g_out and g_lse
    from a seed, lse and Δ from the float32 plain forward."""
    q, k, v, pos = _inputs(case, seed)
    rng = np.random.default_rng(seed + 1)
    bh, t = q.shape[:2]
    g_out = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    g_lse = (torch.from_numpy(rng.standard_normal((bh, t)).astype(np.float32)) if nz_glse
             else torch.zeros(bh, t))
    out, lse = fa.flash_forward_plain(q, k, v, *pos)
    return (q, k, v, g_out, lse, fa.flash_delta(out, g_out), g_lse), pos


def _excess(got, want):
    """``max |got − want|`` over the gate ``RTOL·max|want| + ATOL``."""
    return float((got.double() - want.double()).abs().max()) / (
        RTOL * float(want.abs().max()) + ATOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    """10 significand bits kept; a value halfway between two TF32 values
    rounds away from zero, one just below half rounds down; the split is
    exact before ``small`` is rounded (within 2^-22 after, 2^-21 when
    ``small`` is cut instead)."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2.0 ** -23,
                      3.0, 1 + 3 * one_ulp / 2], dtype=torch.float32)
    assert to_tf32(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 3.0, 1 + 2 * one_ulp]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    big, small = split(y)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert torch.all((y - big).abs() <= big.abs() * 2.0 ** -11)
    assert torch.all((y.double() - big.double() - small.double()).abs()
                     <= y.double().abs() * 2.0 ** -22)
    big, cut = split(y, round_small=False)
    assert not (cut.view(torch.int32) & 0x1FFF).any()
    assert torch.all((y.double() - big.double() - cut.double()).abs()
                     <= y.double().abs() * 2.0 ** -21)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_three_products_keep_to_the_float32_gate(case):
    """Three TF32 products: out and lse within the float32 gate of the
    float64 function with a margin of ``MARGIN`` or more."""
    q, k, v, pos = _inputs(case, case[4])
    out, lse = emulated_forward(q, k, v, pos)
    want, want_lse = reference64(q, k, v, pos)
    assert _excess(out, want) * MARGIN <= 1.0
    assert _excess(lse, want_lse) * MARGIN <= 1.0


@pytest.mark.parametrize("d,causal", JAX_CASES)
def test_three_products_match_the_jax_attention(d, causal):
    """Against the JAX package's float32 attention (its XLA path) at head
    dims 16, 32, 64, 128 and 256: within the float32 gate."""
    b, h, t = 1, 2, 256
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]
    want, want_lse = jax_flash(*map(jnp.asarray, arrays), causal=causal, impl="xla",
                               return_lse=True)
    q, k, v = (torch.from_numpy(a).reshape(b * h, t, d) for a in arrays)
    out, lse = emulated_forward(q, k, v, (0, 0, t, causal, d ** -0.5))
    assert _excess(out.reshape(b, h, t, d), torch.from_numpy(np.array(want))) <= 1.0
    assert _excess(lse.reshape(b, h, t), torch.from_numpy(np.array(want_lse))) <= 1.0


def test_one_product_crosses_the_gate_at_the_planted_case():
    """big·big alone (the planted fault) crosses the float32 gate against
    the float32 plain version at ``offsets_d384``'s shape and masks, while
    three products stay within it."""
    q, k, v, pos = _inputs(OFFSETS_D384, 0)
    want, _ = fa.flash_forward_plain(q, k, v, *pos)
    assert _excess(emulated_forward(q, k, v, pos, n=3)[0], want) <= 1.0
    assert _excess(emulated_forward(q, k, v, pos, n=1)[0], want) > 1.0


@pytest.mark.parametrize("case,nz_glse", BWD_CASES, ids=[c[0][0] for c in BWD_CASES])
def test_three_product_backward_keeps_to_the_float32_gate(case, nz_glse):
    """Three TF32 products in each of K3's and K4's products: dq, dk and dv
    within a tenth of the float32 gate of the float64 function, at phase
    3's float32 cases above 128 (offsets, causal, a masked key tail, a
    nonzero lse cotangent)."""
    args, pos = _backward_inputs(case, case[4], nz_glse)
    for got, want in zip(emulated_backward(*args, pos), backward64(*args, pos)):
        assert _excess(got, want) * MARGIN <= 1.0


@pytest.mark.parametrize("d,causal", JAX_CASES)
def test_three_product_backward_matches_the_jax_vjp(d, causal):
    """Against the vjp of the JAX package's float32 attention (its XLA
    path) at head dims 16, 32, 64, 128 and 256, with offsets, a masked key
    tail and cotangents for both out and lse: dq, dk and dv within the
    float32 gate."""
    b, h, t = 1, 2, 256
    qo, ko, kv_len = 40, 9, 200
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4)]
    g_lse = rng.standard_normal((b, h, t)).astype(np.float32)
    attention = lambda q, k, v: jax_flash(q, k, v, q_offset=qo, k_offset=ko, kv_len=kv_len,
                                          causal=causal, impl="xla", return_lse=True)
    _, vjp = jax.vjp(attention, *map(jnp.asarray, arrays[:3]))
    wants = vjp((jnp.asarray(arrays[3]), jnp.asarray(g_lse)))
    q, k, v, g_out = (torch.from_numpy(a).reshape(b * h, t, d) for a in arrays)
    pos = (qo, ko, kv_len, causal, d ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, *pos)
    got = emulated_backward(q, k, v, g_out, lse, fa.flash_delta(out, g_out),
                            torch.from_numpy(g_lse).reshape(b * h, t), pos)
    for mine, want in zip(got, wants):
        assert _excess(mine.reshape(b, h, t, d), torch.from_numpy(np.array(want))) <= 1.0


def test_one_product_backward_crosses_the_gate_at_the_planted_case():
    """big·big alone in K3's and K4's products crosses the float32 gate
    against the float32 plain versions in one of dq, dk and dv at
    ``offsets_d384``'s shape and masks, while three products keep all three
    within it."""
    args, pos = _backward_inputs(OFFSETS_D384, 0, True)
    want = (fa.flash_dq_plain(*args, *pos), *fa.flash_dkv_plain(*args, *pos))
    three = [_excess(g, w) for g, w in zip(emulated_backward(*args, pos), want)]
    one = [_excess(g, w) for g, w in zip(emulated_backward(*args, pos, n=1), want)]
    assert max(three) <= 1.0
    assert max(one) > 1.0


@pytest.mark.parametrize("case", SMALL_FAULT_CASES, ids=[c[0] for c in SMALL_FAULT_CASES])
def test_one_product_crosses_the_gate_up_to_128(case):
    """Up to head dim 128 (phase 3's float32 cases, the head dim padded as
    the kernels run it): big·big alone crosses the float32 gate against
    the float32 plain versions in K2's out and in one of K4's dk and dv,
    while three products keep all of them within it."""
    q, k, v, pos = _inputs(case, 0)
    dim = fa._kernel_head_dim(case[4], torch.float32)
    q, k, v = (fa._pad_head_dim(x, dim) for x in (q, k, v))
    want, lse = fa.flash_forward_plain(q, k, v, *pos)
    assert _excess(emulated_forward(q, k, v, pos, n=3)[0], want) <= 1.0
    assert _excess(emulated_forward(q, k, v, pos, n=1)[0], want) > 1.0
    rng = np.random.default_rng(1)
    g_out = fa._pad_head_dim(torch.from_numpy(rng.standard_normal(
        q.shape[:2] + (case[4],)).astype(np.float32)), dim)
    g_lse = torch.from_numpy(rng.standard_normal(q.shape[:2]).astype(np.float32))
    args = (q, k, v, g_out, lse, fa.flash_delta(want, g_out), g_lse)
    wants = fa.flash_dkv_plain(*args, *pos)
    three = [_excess(g, w) for g, w in zip(emulated_backward(*args, pos)[1:], wants)]
    one = [_excess(g, w) for g, w in zip(emulated_backward(*args, pos, n=1)[1:], wants)]
    assert max(three) <= 1.0
    assert max(one) > 1.0


@pytest.mark.parametrize("d", [1, 4, 8, 16, 24, 32, 48, 64, 100, 128])
def test_dispatch_up_to_128(d):
    """Up to 128: float32 K2 and K4 on the TF32 kernels, float32 K3 still
    on the CUDA cores, every bfloat16 kernel on wgmma; the head dim padded
    to 16, 32, 64 or 128 for every dtype and kernel."""
    dim = next(x for x in fa.HEAD_DIMS if d <= x)
    for kernel in fa.KERNELS:
        assert fa._kernel_head_dim(d, torch.float32, kernel) == dim
        assert fa.kernel_route(d, torch.bfloat16, kernel) == "wgmma"
    assert fa.kernel_route(d, torch.float32, fa.FWD_KERNEL) == "tf32"
    assert fa.kernel_route(d, torch.float32, fa.DKV_KERNEL) == "tf32"
    assert fa.kernel_route(d, torch.float32, fa.DQ_KERNEL) == "cuda_cores"


@pytest.mark.parametrize("d,dim,dq_tile", [
    (129, 192, 64), (160, 192, 64), (256, 256, 32), (320, 320, 32), (321, 384, 32),
    (384, 384, 32), (448, 512, 16), (512, 512, 16), (513, None, 64)])
def test_dispatch_of_the_wide_head_dims(d, dim, dq_tile):
    """129–512: every kernel, float32 and bfloat16, at the padded head dim;
    above 512 every kernel at ``d``.
    K3's key tiles: 64 up to 192, 32 to 384, 16 at 512 (two 32-key stages
    do not fit beside q and g_out there), 64 sliced."""
    assert fa.wide_head_dim(d) == dim
    assert fa._kernel_head_dim(d, torch.float32) == (dim or d)
    assert fa._kernel_head_dim(d, torch.float32, fa.DQ_KERNEL) == (dim or d)
    assert fa._kernel_head_dim(d, torch.float32, fa.DKV_KERNEL) == (dim or d)
    assert fa._kernel_head_dim(d, torch.bfloat16, fa.DQ_KERNEL) == (dim or d)
    assert fa.dq_key_tile(d) == dq_tile
    for kernel in fa.KERNELS:
        assert fa.kernel_route(d, torch.float32, kernel) == ("tf32" if dim else "sliced")


def test_flash_bound_ms_at_the_timed_shapes():
    """float32 K2 at B 8, H 4, T 4096, d 256: 4·d operations a pair over
    495e12 / 3 op/s, 3.33 ms; bfloat16 K3 at d 384: 6·d over 989e12, 1.2507
    ms; both bound by their products."""
    cs = _chip_smoke()
    assert cs.F32_TENSOR_OPS_PER_S == pytest.approx(1.65e14)
    pairs = 8 * 4 * 4096 * 4096
    exp_per_s = 16 * 132 * 1.98e9
    ms, by, term = cs.flash_bound_ms("flash_attention_fwd", 32, 4096, 4096, 256, pairs, 4,
                                     exp_per_s)
    assert (by, term) == ("operations", "products") and ms == pytest.approx(3.332, abs=1e-3)
    ms, by, term = cs.flash_bound_ms("flash_attention_dq", 32, 4096, 4096, 384, pairs, 2,
                                     exp_per_s)
    assert (by, term) == ("operations", "products") and ms == pytest.approx(1.2507, abs=1e-4)


@pytest.mark.parametrize("case,name,want", [
    ("main_f32", "flash_attention_fwd", 0.833), ("main_f32", "flash_attention_dkv", 1.666),
    ("tsp_f32", "flash_attention_fwd", 0.417), ("tsp_f32", "flash_attention_dkv", 0.833),
    ("d24_long_f32", "flash_attention_fwd", 0.3124),
    ("d24_long_f32", "flash_attention_dkv", 0.6247)])
def test_flash_bound_ms_of_the_float32_cases(case, name, want):
    """Phase 3's timed float32 cases up to 128: path 2's shape at head dim
    32 (B 16, H 4, T 4096), path 16's one-rank shape (B 16, H 8, T 4096, d
    16, causal) and d 24 (B 8, H 4, T 4096; the bound at the true head
    dim), each bound by its products at 495 / 3 TFLOP/s."""
    cs = _chip_smoke()
    _, b, h, t, d, _, causal, qo, ko, kv, _ = next(c for c in cs.FLASH_CASES if c[0] == case)
    pairs = b * h * int(fa._valid_mask(t, t, qo, ko, t if kv is None else kv, causal,
                                       "cpu").sum())
    ms, by, term = cs.flash_bound_ms(name, b * h, t, t, d, pairs, 4, 16 * 132 * 1.98e9)
    assert (by, term) == ("operations", "products") and ms == pytest.approx(want, abs=1e-3)
