"""The port's ring and Ulysses attention (``parallel/ring_attention.py``)
against the JAX package's under ``shard_map``, on the same numpy inputs.

The JAX side runs on the test platform's forced CPU devices with
``impl="xla"``; the port holds one block per rank of a
:class:`~coinstac_dinunet_tpu_torch.parallel.mesh.RankAxis` of ``["cpu"] *
n`` and runs the kernels' plain versions.  Tolerances: outputs and q/k/v
gradients within 1e-5 of the JAX functions (float32; the merge and the
attention sum in another order), and the ring within 1e-5 of the port's own
one-rank ``flash_attention`` over the whole sequence.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from coinstac_dinunet_tpu.parallel.ring_attention import ring_attention as jax_ring
from coinstac_dinunet_tpu.parallel.ring_attention import ulysses_attention as jax_ulysses
from coinstac_dinunet_tpu.utils.jax_compat import shard_map
from coinstac_dinunet_tpu_torch.ops import flash_attention
from coinstac_dinunet_tpu_torch.parallel import ring_attention, ulysses_attention
from coinstac_dinunet_tpu_torch.parallel.mesh import RankAxis
from coinstac_dinunet_tpu_torch.parallel.ring_attention import _merge

ATOL = 1e-5
SPEC = P(None, None, "sp")


def _qkv(seed, b=2, h=4, t=64, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3)]


def _jax(fn, arrays, n, causal):
    """The JAX function's output and the gradients of ``Σ out²`` over the
    whole sequence, ``n`` ranks."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    sharded = shard_map(lambda q, k, v: fn(q, k, v, "sp", causal=causal, impl="xla"),
                        mesh=mesh, in_specs=(SPEC, SPEC, SPEC), out_specs=SPEC)

    def local_loss(q, k, v):
        o = fn(q, k, v, "sp", causal=causal, impl="xla")
        return jax.lax.psum(jnp.sum(o ** 2), "sp")

    loss = shard_map(local_loss, mesh=mesh, in_specs=(SPEC, SPEC, SPEC), out_specs=P())

    args = [jnp.asarray(a) for a in arrays]
    out = np.asarray(jax.jit(sharded)(*args))
    grads = [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)]
    return out, grads


def _port(fn, arrays, n, causal):
    """The port function over ``n`` CPU ranks: the whole output and the
    gradients, reassembled along the sequence."""
    axis = RankAxis("sp", ["cpu"] * n)
    full = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    blocks = [list(torch.chunk(x, n, dim=2)) for x in full]
    outs = fn(*blocks, axis, causal=causal)
    out = torch.cat(outs, dim=2)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in full]


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring(n, causal):
    arrays = _qkv(n + int(causal))
    _close(_port(ring_attention, arrays, n, causal), _jax(jax_ring, arrays, n, causal))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_matches_jax_ulysses(n, causal):
    # batch 1, as the JAX package's own Ulysses gradient test: its
    # all_to_all transposes to a wrong-shaped cotangent when the batch
    # equals the axis size
    arrays = _qkv(10 + n + int(causal), b=1)
    _close(_port(ulysses_attention, arrays, n, causal),
           _jax(jax_ulysses, arrays, n, causal))


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_matches_one_rank_flash(fn, causal):
    """The ring and Ulysses at sp = 4 against the port's own
    ``flash_attention`` over the whole sequence (outputs and gradients)."""
    arrays = _qkv(20 + int(causal), t=128)
    full = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = flash_attention(*full, causal=causal)
    (out ** 2).sum().backward()
    _close(_port(fn, arrays, 4, causal), (out.detach().numpy(), [x.grad.numpy() for x in full]))


def test_fully_masked_hops_merge_to_nothing():
    """Rank 0 of a causal ring sees only later ranks' blocks after its
    first hop: every one fully masked (lse at the sentinel, zeros), each
    merged with weight 0 and NaN-free, the backward's ``g_lse`` included."""
    arrays = _qkv(30, b=1, h=2, t=32)
    q, k, v = [torch.from_numpy(a[:, :, :8].copy()).requires_grad_(True) for a in arrays]
    k_late = torch.from_numpy(arrays[1][:, :, 8:16].copy())
    o, lse = flash_attention(q, k_late, v.detach(), q_offset=0, k_offset=8, causal=True,
                             return_lse=True)
    assert torch.all(o == 0) and torch.all(lse < -5e29)
    o0, lse0 = flash_attention(q, k, v, causal=True, return_lse=True)
    acc, m = _merge(o0.float(), lse0, o.float(), lse)
    np.testing.assert_allclose(acc.detach().numpy(), o0.detach().numpy(), atol=1e-7)
    np.testing.assert_allclose(m.detach().numpy(), lse0.detach().numpy(), atol=1e-6)
    (acc.sum() + m.sum()).backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


def test_axis_and_shape_checks():
    axis = RankAxis("sp", ["cpu"] * 3)
    q, k, v = (list(torch.zeros(1, 4, 12, 16).chunk(3, dim=2)) for _ in range(3))
    with pytest.raises(ValueError, match="must divide"):
        ulysses_attention(q, k, v, axis)
    with pytest.raises(ValueError, match="one block per rank"):
        ring_attention(q[:2], k[:2], v[:2], axis)
