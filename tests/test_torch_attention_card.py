"""The flash-attention kernels K2 (forward), K3 (dq) and K4 (dk/dv) on the
card against their plain PyTorch versions.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a card.  This file imports neither JAX nor the
JAX package, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_attention_card.py``.

Tolerance: 1e-4 of the plain output's largest magnitude plus 1e-6 (both
compute in float32 from the same inputs; they differ in the order of the
float32 sums and in ``expf`` against torch's ``exp``).  The backward kernels
take no atomics, so two launches agree bit for bit.

The float32 K2 and K4 run on the tensor cores as three TF32 products a
float32 product (``csrc/flash_attention_tf32.cuh``) at every head dim up
to 512 (zero-padded to 16, 32, 64, 128, 192, 256, 320, 384 or 512), the
float32 K3 there above 128 (up to 128 on the CUDA cores), and all three at
576 on the sliced kernels (``csrc/flash_attention_wide.cuh``), in float32
on the CUDA cores: everywhere the same tolerances hold.  The bfloat16 K2, K3 and K4 run
on the tensor cores up to 512 (``csrc/flash_attention_wide_wgmma.cuh``,
padded the same way), at 576 on the sliced kernels, all with the
roundings below, and are held as below; at T 2048 also to the derived
bound of ``ops/flash_attention.py`` (one bfloat16 step for each ``p`` or
``ds`` the kernels' float32 arithmetic may round the other way, plus
1e-4·max + 1e-6), against which a fixed ratio has no margin.

For bfloat16 inputs K2, K3 and K4 round ``p`` (and in the backward
``g_out`` and ``ds``) to bfloat16 before their second products, on the
tensor cores or, where the sliced kernels run, on the CUDA cores.  They are held to the float32 plain version within 2e-2·max + 1e-6
(the format's error) and to the plain version with the same roundings
(``round_dtype=torch.bfloat16``; for K2 the online softmax over the
kernel's key tiles).  What is left against that one is the order of the
float32 sums and, here and there, a bfloat16 rounding of ``p`` or ``ds``
that falls the other way, because the two sides' float32 values differ in
their last bits; such a term then moves by 2^-8 of itself.  Over thousands
of keys it drowns in the sum (T 2048: within 1e-3·max + 1e-6); where a row
sees a few hundred keys or fewer, one flipped term is worth up to 2^-8 of
the largest output (2.2e-3 was seen), so the short cases are held to
4e-3·max + 1e-6.  lse stays within 1e-4·max + 1e-6 in both types.
"""
import importlib

import pytest
import torch

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

# the instantiated head dims and, above 128, head dims K2, K3 and K4 of
# both types pad to 192, 256, 320, 384 and 512, and 576, where all three
# run on the sliced kernels
KERNEL_HEAD_DIMS = (*fa.HEAD_DIMS, 160, 256, 320, 384, 512, 576)

CASES = [  # (causal, q_offset, k_offset, kv_len, g_lse nonzero)
    (False, 0, 0, 160, True), (True, 0, 0, 160, True), (False, 0, 0, 96, False),
    (False, 0, 0, 0, False), (True, 0, 64, 160, False), (True, 100, 37, 150, True),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


BF16_MATCHED_RTOL, BF16_MATCHED_RTOL_SHORT, BF16_RTOL = 1e-3, 4e-3, 2e-2


def _close(got, want, rtol=1e-4):
    tol = rtol * float(want.abs().max()) + 1e-6
    assert float((got - want).abs().max()) <= tol


def _inputs(dev, d, dtype, case, bh=3, t=160):
    causal, qo, ko, kv, nz = case
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = [torch.randn((bh, t, d), generator=g, device=dev).to(dtype) for _ in range(3)]
    pos = (qo, ko, kv, causal, d ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, *pos)
    g_out = torch.randn(out.shape, generator=g, device=dev)
    g_lse = torch.randn(lse.shape, generator=g, device=dev) * nz
    return (q, k, v), pos, (out, lse, g_out, g_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_forward_kernel_matches_plain(card, d, dtype):
    """float32: within 1e-4·max of the plain version.  bfloat16 (the
    tensor-core kernel): within 4e-3·max of the rounding-matched plain
    version and 2e-2·max of the float32 one.  lse within 1e-4·max."""
    for case in CASES:
        qkv, pos, _ = _inputs(card, d, dtype, case)
        launches = fa.FWD_KERNEL.launches
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        assert fa.FWD_KERNEL.launches == launches + 1
        want_out, want_lse = fa.flash_forward_plain(*qkv, *pos)
        if dtype == torch.bfloat16:
            _close(out, fa.flash_forward_plain(*qkv, *pos, round_dtype=dtype)[0],
                   BF16_MATCHED_RTOL_SHORT)
            _close(out, want_out, BF16_RTOL)
        else:
            _close(out, want_out)
        _close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 256, 384, 512])
def test_f32_wide_forward_of_a_long_sequence(card, d):
    """The float32 K2 at every instantiated head dim (three TF32 products a
    float32 product) over many key tiles, unmasked and causal: within
    1e-4·max of the float32 plain version (TF32 off), out and lse, and
    bit-identical reruns."""
    for case in [(False, 0, 0, 1024, False), (True, 0, 0, 1024, False)]:
        qkv, pos, _ = _inputs(card, d, torch.float32, case, bh=2, t=1024)
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        want_out, want_lse = fa.flash_forward_plain(*qkv, *pos)
        _close(out, want_out)
        _close(lse, want_lse)
        again = fa.flash_forward_cuda(*qkv, *pos)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 256, 384, 512])
def test_f32_wide_backward_of_a_long_sequence(card, d):
    """The float32 K3 and K4 over many key and query tiles, unmasked and
    causal, with a nonzero lse cotangent: dq, dk and dv within 1e-4·max of
    the float32 plain versions (TF32 off), and bit-identical reruns.  K4 at
    every instantiated head dim and K3 above 128 run as three TF32 products
    a float32 product; K3 up to 128 on the CUDA cores."""
    for case in [(False, 0, 0, 1024, True), (True, 0, 0, 1024, True)]:
        qkv, pos, (out, lse, g_out, g_lse) = _inputs(card, d, torch.float32, case, bh=2, t=1024)
        args = (*qkv, g_out, lse, fa.flash_delta(out, g_out), g_lse, *pos)
        dq = fa.flash_dq_cuda(*args)
        dk, dv = fa.flash_dkv_cuda(*args)
        _close(dq, fa.flash_dq_plain(*args))
        for got, want in zip((dk, dv), fa.flash_dkv_plain(*args)):
            _close(got, want)
        assert torch.equal(dq, fa.flash_dq_cuda(*args))
        assert all(torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_dkv_cuda(*args)))


@pytest.mark.cuda
def test_bf16_forward_of_a_long_sequence(card):
    """Many key tiles (the ring wraps, the running max moves), mask-free and
    diagonal tiles, at the sequence model's head dim: 1e-3·max of the
    rounding-matched plain version."""
    for case in [(False, 0, 0, 2048, False), (True, 0, 0, 2048, False)]:
        qkv, pos, _ = _inputs(card, 32, torch.bfloat16, case, t=2048)
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        want_out, want_lse = fa.flash_forward_plain(*qkv, *pos, round_dtype=torch.bfloat16)
        _close(out, want_out, BF16_MATCHED_RTOL)
        _close(lse, want_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_bf16_forward_repeats_bit_for_bit(card, d):
    for case in CASES:
        qkv, pos, _ = _inputs(card, d, torch.bfloat16, case, t=333)
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        out2, lse2 = fa.flash_forward_cuda(*qkv, *pos)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_bf16_forward_of_fully_masked_rows(card, d):
    """No valid key (kv_len 0), or a causal slice before every key: zeros
    and the sentinel lse, at or below −5e29 (what the backward reads as
    "fully masked"), not merely a large negative number."""
    for case in [(False, 0, 0, 0, False), (True, 0, 200, 160, False)]:
        qkv, pos, _ = _inputs(card, d, torch.bfloat16, case)
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        assert out.abs().max() == 0
        assert bool((lse <= fa._MASKED_LSE).all())


def _backward_args(dev, d, case, dtype=torch.float32, t=160):
    (q, k, v), pos, (out, lse, g_out, g_lse) = _inputs(dev, d, dtype, case, t=t)
    return (q, k, v, g_out, lse, fa.flash_delta(out, g_out), g_lse, *pos)


@pytest.mark.cuda
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_dq_kernel_matches_plain_and_repeats_bit_for_bit(card, d):
    for case in CASES:
        args = _backward_args(card, d, case)
        dq = fa.flash_dq_cuda(*args)
        _close(dq, fa.flash_dq_plain(*args))
        assert torch.equal(dq, fa.flash_dq_cuda(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_dkv_kernel_matches_plain_and_repeats_bit_for_bit(card, d):
    for case in CASES:
        args = _backward_args(card, d, case)
        dk, dv = fa.flash_dkv_cuda(*args)
        for got, want in zip((dk, dv), fa.flash_dkv_plain(*args)):
            _close(got, want)
        assert all(torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_dkv_cuda(*args)))
        if case[3] < 160:  # keys past kv_len: exactly zero gradient
            assert dk[:, case[3]:].abs().max() == 0 and dv[:, case[3]:].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [160, 333])
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_bf16_dq_kernel_matches_both_plain_versions(card, d, t):
    """K3 on the tensor cores: ragged T, causal with offsets, a masked key
    tail, no valid key at all; bit-identical reruns.  The witness that ``ds``
    went to the tensor cores in bfloat16: on the mean over the elements, the
    kernel lies closer to the rounded plain dq than to the unrounded one (a
    single ``ds`` rounded the other way can make the largest distance to
    either the larger at a short T)."""
    for case in CASES:
        args = _backward_args(card, d, case, torch.bfloat16, t)
        launches = fa.DQ_KERNEL.launches
        dq = fa.flash_dq_cuda(*args)
        assert fa.DQ_KERNEL.launches == launches + 1
        rounded = fa.flash_dq_plain(*args, round_dtype=torch.bfloat16)
        exact = fa.flash_dq_plain(*args)
        _close(dq, rounded, BF16_MATCHED_RTOL_SHORT)
        _close(dq, exact, BF16_RTOL)
        assert torch.equal(dq, fa.flash_dq_cuda(*args))
        if case[3] == 0:
            assert dq.abs().max() == 0
        else:
            assert float((dq - exact).abs().mean()) > float((dq - rounded).abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [160, 333])
@pytest.mark.parametrize("d", KERNEL_HEAD_DIMS)
def test_bf16_dkv_kernel_matches_both_plain_versions(card, d, t):
    """K4 on the tensor cores, with exactly zero dk and dv past kv_len."""
    for case in CASES:
        args = _backward_args(card, d, case, torch.bfloat16, t)
        launches = fa.DKV_KERNEL.launches
        dk, dv = fa.flash_dkv_cuda(*args)
        assert fa.DKV_KERNEL.launches == launches + 1
        matched = fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16)
        for got, want_m, want in zip((dk, dv), matched, fa.flash_dkv_plain(*args)):
            _close(got, want_m, BF16_MATCHED_RTOL_SHORT)
            _close(got, want, BF16_RTOL)
        assert all(torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_dkv_cuda(*args)))
        if case[3] < t:  # keys past kv_len: exactly zero gradient
            assert dk[:, case[3]:].abs().max() == 0 and dv[:, case[3]:].abs().max() == 0


@pytest.mark.cuda
def test_bf16_backward_of_a_long_sequence(card):
    """Many streamed tiles (the ring wraps several times), both mask-free
    and diagonal tiles, at the sequence model's head dim."""
    for case in [(False, 0, 0, 2048, False), (True, 0, 0, 2048, True)]:
        args = _backward_args(card, 32, case, torch.bfloat16, 2048)
        got = (fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
        matched = (fa.flash_dq_plain(*args, round_dtype=torch.bfloat16),
                   *fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16))
        for a, b in zip(got, matched):
            _close(a, b, BF16_MATCHED_RTOL)


@pytest.mark.cuda
def test_bf16_kernels_at_head_dim_16_of_a_long_sequence(card):
    """The sequence example's head dim (d_model 64 over 4 heads): one
    16-deep slice for Q·Kᵀ, N = 16 for P·V, the 32-byte swizzle; many key
    tiles, mask-free and diagonal ones, against the rounding-matched plain
    versions within 1e-3·max."""
    for case in [(False, 0, 0, 2048, False), (True, 0, 0, 2048, True)]:
        qkv, pos, _ = _inputs(card, 16, torch.bfloat16, case, t=2048)
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        want_out, want_lse = fa.flash_forward_plain(*qkv, *pos, round_dtype=torch.bfloat16)
        _close(out, want_out, BF16_MATCHED_RTOL)
        _close(lse, want_lse)
        args = _backward_args(card, 16, case, torch.bfloat16, 2048)
        got = (fa.flash_dq_cuda(*args), *fa.flash_dkv_cuda(*args))
        matched = (fa.flash_dq_plain(*args, round_dtype=torch.bfloat16),
                   *fa.flash_dkv_plain(*args, round_dtype=torch.bfloat16))
        for a, b in zip(got, matched):
            _close(a, b, BF16_MATCHED_RTOL)


@pytest.mark.cuda
def test_autograd_function_launches_the_kernels_at_head_dim_16(card):
    """The sequence example's attention shape, (B 8, H 4, T 128, d 16),
    through the autograd function: one launch of each kernel."""
    q, k, v = [torch.randn((8, 4, 128, 16), device=card, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3)]
    before = [kern.launches for kern in fa.KERNELS]
    out = fa.flash_attention(q, k, v)
    out.float().pow(2).sum().backward()
    assert [kern.launches - b for kern, b in zip(fa.KERNELS, before)] == [1, 1, 1]
    assert torch.isfinite(q.grad.float()).all()


@pytest.mark.cuda
def test_autograd_function_launches_the_kernels(card):
    q, k, v = [torch.randn((2, 4, 200, 32), device=card, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3)]
    before = [kern.launches for kern in fa.KERNELS]
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().pow(2).sum().backward()
    assert [kern.launches - b for kern, b in zip(fa.KERNELS, before)] == [1, 1, 1]
    assert out.dtype == q.grad.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_launches_the_kernels_above_head_dim_128(card, dtype):
    """Head dim 256 through the autograd function: one launch of each
    kernel (the tensor-core K2, K3 and K4: wgmma in bfloat16, three TF32
    products a float32 product in float32), never the plain version."""
    q, k, v = [torch.randn((2, 2, 200, 256), device=card, dtype=dtype,
                           requires_grad=True) for _ in range(3)]
    before = [kern.launches for kern in fa.KERNELS]
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().pow(2).sum().backward()
    assert [kern.launches - b for kern, b in zip(fa.KERNELS, before)] == [1, 1, 1]
    assert torch.isfinite(q.grad.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [160, 256, 320, 384])
def test_bf16_wide_kernels_of_a_long_sequence_keep_to_the_derived_bound(card, d):
    """The tensor-core K2 and K4 above 128 over many key and query tiles,
    mask-free and causal, within the derived bound of their
    rounding-matched function (1e-4·max + 1e-6 beside it), one launch
    each; at d 384 the 32-key tiles of both."""
    for case in [(False, 0, 0, 2048, False), (True, 0, 0, 2048, True)]:
        qkv, pos, _ = _inputs(card, d, torch.bfloat16, case, bh=2, t=2048)
        before = fa.FWD_KERNEL.launches
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        assert fa.FWD_KERNEL.launches == before + 1
        want, bound = fa.rounding_bound_forward(*qkv, *pos)
        assert fa.bound_excess(out, want, bound, 1e-4, 1e-6) <= 1
        _close(lse, fa.flash_forward_plain(*qkv, *pos)[1])
        args = _backward_args(card, d, case, torch.bfloat16, 2048)
        got = fa.flash_dkv_cuda(*args)
        for g, w, b in zip(got, *fa.rounding_bound_backward(*args, dq=False)):
            assert fa.bound_excess(g, w, b, 1e-4, 1e-6) <= 1


@pytest.mark.cuda
def test_unsupported_head_dim_raises(card):
    q = torch.zeros((1, 8, 0), device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_forward_cuda(q, q, q, 0, 0, 8, False, 1.0)
