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
"""
import importlib

import pytest
import torch

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

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


def _close(got, want):
    tol = 1e-4 * float(want.abs().max()) + 1e-6
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
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_forward_kernel_matches_plain(card, d, dtype):
    for case in CASES:
        qkv, pos, _ = _inputs(card, d, dtype, case)
        launches = fa.FWD_KERNEL.launches
        out, lse = fa.flash_forward_cuda(*qkv, *pos)
        assert fa.FWD_KERNEL.launches == launches + 1
        want_out, want_lse = fa.flash_forward_plain(*qkv, *pos)
        _close(out, want_out)
        _close(lse, want_lse)


def _backward_args(dev, d, case):
    (q, k, v), pos, (out, lse, g_out, g_lse) = _inputs(dev, d, torch.float32, case)
    return (q, k, v, g_out, lse, fa.flash_delta(out, g_out), g_lse, *pos)


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_dq_kernel_matches_plain_and_repeats_bit_for_bit(card, d):
    for case in CASES:
        args = _backward_args(card, d, case)
        dq = fa.flash_dq_cuda(*args)
        _close(dq, fa.flash_dq_plain(*args))
        assert torch.equal(dq, fa.flash_dq_cuda(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
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
def test_autograd_function_launches_the_kernels(card):
    q, k, v = [torch.randn((2, 4, 200, 32), device=card, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3)]
    before = [kern.launches for kern in fa.KERNELS]
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().pow(2).sum().backward()
    assert [kern.launches - b for kern, b in zip(fa.KERNELS, before)] == [1, 1, 1]
    assert out.dtype == q.grad.dtype == torch.bfloat16


@pytest.mark.cuda
def test_unsupported_head_dim_raises(card):
    q = torch.zeros((1, 1, 8, 48), device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
