"""The derived bound of ``ops/flash_attention.py`` on the CPU: how far the
bfloat16 tensor-core flash-attention kernels may lie from their
rounding-matched function, element by element.

The kernels run only on the card (``chip_smoke.py`` phase 3 holds them to
the bound there).  Here the bound is held to what it claims on float32
computations the CPU can make: the rounding-matched plain versions
(float32 scores from another summation order, ``exp`` for ``ex2``) must
stay within it of the float64 reference, and the two planted faults of
phase 3 (one key tile dropped; ``p`` and ``ds`` rounded to float16 instead
of bfloat16) must cross it.  "Within" is the phase-3 gate: ``|got - want| <=
bound + 1e-4·max|want| + 1e-6`` everywhere.
"""
import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

RTOL, ATOL = 1e-4, 1e-6  # chip_smoke.FLASH_RTOL, FLASH_ATOL
# 384: K2 and K4 on the tensor cores over 32-key and 32-query tiles, K3 on
# the sliced kernel, which rounds ds as they do
HEAD_DIMS = (24, 160, 256, 320, 384)


@pytest.fixture(autouse=True)
def one_thread():
    """The bound is many small float64 operations: on one thread each, as
    several test workers share the machine's cores (eight threads a worker
    made these tests 100× slower under six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, d, t=512, bh=2):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, t, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    g_out = torch.from_numpy(rng.normal(size=(bh, t, d)).astype(np.float32))
    g_lse = torch.from_numpy(rng.normal(size=(bh, t)).astype(np.float32))
    pos = (0, 0, t, False, d ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, *pos)
    return (q, k, v), pos, (q, k, v, g_out, lse, fa.flash_delta(out, g_out), g_lse, *pos)


def test_tc_dot_error_covers_float32_sums():
    """The bound on a float32 sum of bfloat16 products covers the CPU's
    float32 product of the same tiles, with room to spare, and the exact
    product is float64's."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.normal(size=(2, 300, 256)).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(2))
    err, exact = fa.tc_dot_error(a, b)
    assert torch.equal(exact, a.double() @ b.double().transpose(1, 2))
    seen = (a @ b.transpose(1, 2)).double() - exact
    assert bool((seen.abs() <= err).all())
    assert float((seen.abs() / err).max()) < 0.5


def test_near_boundary_flags_values_by_their_distance_to_a_rounding_midpoint():
    one = torch.tensor([1.0], dtype=torch.float64)
    h = 2.0 ** -7  # bfloat16's spacing in [1, 2)
    mid = one + h / 2  # halfway between 1 and 1 + h
    # just above the midpoint (by more than float32's spacing 2^-23, so the
    # value survives the rounding through float32): up, and near it
    rounded, step = fa.near_rounding_boundary(mid + 2e-7, torch.tensor([1e-6], dtype=torch.float64))
    assert float(step) == h and float(rounded) == 1 + h
    _, step = fa.near_rounding_boundary(mid + 1e-4, torch.tensor([1e-6], dtype=torch.float64))
    assert float(step) == 0
    _, step = fa.near_rounding_boundary(torch.zeros(1, dtype=torch.float64), torch.ones(1))
    assert float(step) == 0  # an exact zero never rounds to anything else
    x = torch.from_numpy(np.random.default_rng(2).lognormal(size=1000))
    rounded, _ = fa.near_rounding_boundary(x, torch.zeros_like(x), torch.float16)
    assert torch.equal(rounded, x.float().half().double())


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_float32_rounding_matched_plain_versions_keep_to_the_bound(d):
    """The float32 rounding-matched plain K2, K3 and K4 (every kernel
    rounds, ``rounds_at``) lie within the bound of the float64
    reference."""
    qkv, pos, args = _inputs(d, d)
    want, bound = fa.rounding_bound_forward(*qkv, *pos)
    got = fa.flash_forward_plain(*qkv, *pos, round_dtype=torch.bfloat16)[0]
    assert fa.bound_excess(got, want, bound, RTOL, ATOL) <= 1
    wants, bounds = fa.rounding_bound_backward(*args, dq=False)
    for g, w, b in zip(fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16), wants, bounds):
        assert fa.bound_excess(g, w, b, RTOL, ATOL) <= 1
    if fa.rounds_at(d, dq=True):
        (w,), (b,) = fa.rounding_bound_backward(*args, dq=True)
        assert fa.bound_excess(fa.flash_dq_plain(*args, round_dtype=torch.bfloat16), w, b,
                         RTOL, ATOL) <= 1


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_planted_faults_cross_the_bound(d):
    """One key tile dropped (K2, K3: ``kv_len`` one tile of the kernel's
    short; K4: the lse of the first query tile padded, so its ``p`` is 0)
    and the rounding in float16 instead of bfloat16: every output crosses
    its bound (K3 where it rounds: everywhere)."""
    qkv, pos, args = _inputs(50 + d, d)
    q_offset, k_offset, kv_len, causal, scale = pos
    want, bound = fa.rounding_bound_forward(*qkv, *pos)
    dropped = fa.flash_forward_plain(*qkv, q_offset, k_offset, kv_len - fa.fwd_key_tile(d),
                                     causal, scale, round_dtype=torch.bfloat16)[0]
    f16 = fa.rounding_bound_forward(*qkv, *pos, round_dtype=torch.float16)[0]
    assert fa.bound_excess(dropped, want, bound, RTOL, ATOL) > 1
    assert fa.bound_excess(f16, want, bound, RTOL, ATOL) > 1
    wants, bounds = fa.rounding_bound_backward(*args, dq=False)
    lse_cut = args[4].clone()
    lse_cut[:, :64] = fa._LSE_PAD
    dropped = fa.flash_dkv_plain(*args[:4], lse_cut, *args[5:], round_dtype=torch.bfloat16)
    f16 = fa.rounding_bound_backward(*args, dq=False, round_dtype=torch.float16)[0]
    for w, b, x, y in zip(wants, bounds, dropped, f16):
        assert fa.bound_excess(x, w, b, RTOL, ATOL) > 1 and fa.bound_excess(y, w, b, RTOL, ATOL) > 1
    if fa.rounds_at(d, dq=True):
        (w,), (b,) = fa.rounding_bound_backward(*args, dq=True)
        dropped = fa.flash_dq_plain(*args[:7], q_offset, k_offset, kv_len - fa.dq_key_tile(d),
                                    causal, scale, round_dtype=torch.bfloat16)
        f16 = fa.rounding_bound_backward(*args, dq=True, round_dtype=torch.float16)[0][0]
        assert fa.bound_excess(dropped, w, b, RTOL, ATOL) > 1 and fa.bound_excess(f16, w, b, RTOL, ATOL) > 1


def test_bound_is_a_small_share_of_the_output():
    """What the flips may be worth, element by element, stays near the
    fixed ratio it stands in for (1e-3 of the largest output): at d 256, T
    512, the median element's bound under 3e-4 of the largest output, the
    largest under 5e-3."""
    qkv, pos, args = _inputs(7, 256)
    want, bound = fa.rounding_bound_forward(*qkv, *pos)
    assert fa.bound_share(bound, want) < 5e-3
    assert float(bound.median()) < 3e-4 * float(want.abs().max())
