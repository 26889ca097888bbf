"""The int8 wire codec's kernel K1 on the card against its plain PyTorch
version, bit for bit.

The kernel has no CPU mode, so every test here carries the ``cuda`` marker
and skips without a card.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quantize_card.py``.
"""
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.ops import quantize as tq
from coinstac_dinunet_tpu_torch.utils import tensorutils as ttu


def _vbm_leaves(seed=0):
    """The width-16 VBM gradient's 23 wire leaves (random values, wire
    order and flax layout)."""
    from coinstac_dinunet_tpu_torch.interop import to_flax, wire_leaves
    from coinstac_dinunet_tpu_torch.models import VBM3DNet

    models = {"vbm_net": VBM3DNet(width=16)}
    shapes = [tuple(to_flax(models[m], p, models[m].get_parameter(p)).shape)
              for m, p in wire_leaves(models)]
    assert len(shapes) == 23
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=s) * 1e-2).astype(np.float32)) for s in shapes]


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for shape in [(1,), (127,), (129,), (3, 3, 3, 64, 128), (1 << 20,)]:
        x = torch.randn(shape, device=dev)
        vals, scales, _ = tq.quantize_int8(x, seed=3)
        n = x.numel()
        rows = -(-n // tq.GROUP)
        groups = torch.nn.functional.pad(x.reshape(-1), (0, rows * tq.GROUP - n))
        pv, ps = tq.quantize_int8_plain(groups.view(rows, tq.GROUP), 3)
        assert torch.equal(vals, pv)
        assert torch.equal(scales.view(torch.int32), ps.view(torch.int32))
    # the batched kernel against the batched plain version: one VBM
    # gradient, the edges (with a zero-size leaf), a 16-byte-misaligned
    # view, 200 segments, and values that take the kernel's exact division
    # (zeros, tiny and subnormal values, a huge scale, NaN and infinity) or
    # lie at the edges of its shared-reciprocal path
    vbm = [x.to(dev) for x in _vbm_leaves()]
    special = torch.randn(12, 128, device=dev)
    special[0, ::3] = 0.0
    special[1] = 0.0
    special[2, 5] = 1e-30
    special[3] = 1e-42
    special[4] *= 1e30
    special[5, 9] = float("nan")
    special[6, 1] = float("inf")
    special[7, 2] = -float("inf")
    special[8] = torch.round(special[8] * 10) / 10  # exact multiples
    special[9] *= 1e-12
    # the edges of the shared-reciprocal path: a scale just under 2^40
    # (|x| up to 127 * 2^40), and one just over 2^-40 with every |x| >= 2^-40
    special[10] *= 127 * 0.999 * 2.0 ** 40 / special[10].abs().max()
    special[11] = torch.sign(special[11]) * 2.0 ** -40 * (1 + 126 * torch.rand(128, device=dev))
    special[11, 0] = 128 * 2.0 ** -40
    edges = [torch.randn(s, device=dev) for s in [(1,), (127,), (0,), (129,), (3, 3)]]
    misaligned = [torch.randn(1001, device=dev)[1:], torch.randn(64, 9, device=dev).t()]
    many = [torch.randn(1 + i % 200, device=dev) for i in range(200)]
    cases = ((vbm, 1), (edges, 1), (misaligned, 1), (many, 4), ([special, special[3:]], 1))
    for leaves, launches in cases:
        seeds = [2 ** 31 - 7 + 3 * i for i in range(len(leaves))]
        before, segs_before = tq.KERNEL.launches, tq.KERNEL.segments
        got = tq.quantize_int8_many(leaves, seeds)
        assert tq.KERNEL.launches - before == launches
        assert tq.KERNEL.segments - segs_before == sum(x.numel() > 0 for x in leaves)
        want = tq.quantize_int8_many_plain(leaves, seeds)
        torch.cuda.synchronize()
        assert got.is_cuda and torch.equal(got, want)


@pytest.mark.cuda
def test_payload_from_the_card_equals_the_cpu_payload():
    """One launch and one pinned copy per payload write the bytes the CPU
    path writes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    cpu = _vbm_leaves(seed=3)
    arrays = cpu[:5] + [np.arange(5, dtype=np.int64)] + cpu[5:] + [torch.zeros((0, 3))]
    on_card = [a.cuda() if isinstance(a, torch.Tensor) else a for a in arrays]
    before = tq.KERNEL.launches
    assert ttu.pack_arrays(on_card, codec="int8", seed=17) == \
        ttu.pack_arrays(arrays, codec="int8", seed=17)
    assert tq.KERNEL.launches - before == 1
