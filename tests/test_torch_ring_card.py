"""Ring and Ulysses attention (``parallel/ring_attention.py``) on the card,
through the flash kernels K2 (forward) and K3/K4 (backward), against one
``flash_attention`` call over the whole sequence on the same card.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips without a card.  This file imports neither JAX nor the
JAX package: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ring_card.py``.  The ranks share the card
(``["cuda:0"] * n``).

Tolerances: float32, 1e-4 of the one-call result's largest magnitude plus
1e-6 (the ring merges its hops' partials in another order); bfloat16,
2e-2·max + 1e-6, the format's error: every hop's partial output is rounded
to bfloat16 before the float32 merge, where the one call rounds once.  A
causal ring's fully masked hops (every later rank's block, seen by rank 0
after its first hop) launch K2–K4 like any other: their rows report the
sentinel lse and zeros, and K3/K4 give them zero gradients although the
merge hands them a nonzero ``g_lse``.
"""
import importlib

import pytest
import torch

from coinstac_dinunet_tpu_torch.ops import flash_attention
from coinstac_dinunet_tpu_torch.parallel import ring_attention, ulysses_attention
from coinstac_dinunet_tpu_torch.parallel.mesh import RankAxis

fa = importlib.import_module("coinstac_dinunet_tpu_torch.ops.flash_attention")

RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, rtol):
    tol = rtol * float(want.float().abs().max()) + 1e-6
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


def _qkv(dev, dtype, b=2, h=4, t=1024, d=32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, h, t, d), generator=g, device=dev).to(dtype) for _ in range(3)]


def _run(fn, arrays, n, causal, g_out):
    full = [a.clone().requires_grad_(True) for a in arrays]
    if fn is None:
        out = flash_attention(*full, causal=causal)
    else:
        axis = RankAxis("sp", [arrays[0].device] * n)
        out = torch.cat(fn(*[list(x.chunk(n, dim=2)) for x in full], axis, causal=causal), dim=2)
    (out.float() * g_out).sum().backward()
    return out.detach(), [x.grad for x in full]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn,n", [(ring_attention, 2), (ring_attention, 4),
                                  (ulysses_attention, 2), (ulysses_attention, 4)])
def test_sequence_parallel_matches_one_call_on_the_card(card, fn, n, causal, dtype):
    arrays = _qkv(card, dtype)
    g_out = torch.randn(arrays[0].shape, device=card,
                        generator=torch.Generator(device=card).manual_seed(1))
    want = _run(None, arrays, n, causal, g_out)
    before = [k.launches for k in fa.KERNELS]
    got = _run(fn, arrays, n, causal, g_out)
    calls = n * n if fn is ring_attention else n
    assert [k.launches - b for k, b in zip(fa.KERNELS, before)] == [calls] * 3
    _close(got[0], want[0], RTOL[dtype])
    for g, w in zip(got[1], want[1]):
        assert torch.isfinite(g).all()
        _close(g, w, RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fully_masked_hop_on_the_card(card, dtype):
    """Rank 0's view of rank 1's block in a causal ring: zeros and the
    sentinel lse from K2, zero gradients from K3/K4 under a nonzero
    ``g_lse``, as the plain versions give."""
    q, k, v = [a.requires_grad_(True) for a in _qkv(card, dtype, t=512, seed=3)]
    out, lse = flash_attention(q, k, v, q_offset=0, k_offset=512, causal=True,
                               return_lse=True)
    assert torch.all(out == 0) and torch.all(lse < -5e29)
    g = torch.Generator(device=card).manual_seed(4)
    g_out = torch.randn(out.shape, device=card, generator=g)
    g_lse = torch.randn(lse.shape, device=card, generator=g)
    ((out.float() * g_out).sum() + (lse * g_lse).sum()).backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all() and torch.all(t.grad == 0)
