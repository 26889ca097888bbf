"""The port's low-rank compression math (``ops/power_iteration.py``)
against the JAX package's on the same numpy inputs.

``orthogonalize``: QR may choose other column signs, so the tests compare
the projector ``Q Qᵀ`` and which columns come out zero (tolerance 1e-5
on values of order 1) on random, rank-1, rank-deficient and zero-column
inputs.  ``power_iteration_BC``: the JAX start block is
drawn from its key in the test and injected into the port as ``q0``; the
product ``Brᵀ Cr`` is compared within 1e-4·max|Bᵀ C|.  The two exact
branches take no start block and are compared the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops import orthogonalize as jax_orthogonalize
from coinstac_dinunet_tpu.ops import power_iteration_BC as jax_power_iteration_BC
from coinstac_dinunet_tpu_torch.ops import orthogonalize, power_iteration_BC

PROJ_ATOL = 1e-5
RTOL = 1e-4


def _inputs():
    rng = np.random.default_rng(0)
    random = rng.normal(size=(20, 4)).astype(np.float32)
    rank1 = rng.normal(size=(20, 1)).astype(np.float32)
    # rank 3 of 4, the dependent column last (a column after it would be
    # orthogonalized against the direction QR makes up, which is
    # arbitrary), in float64: in float32 the dependent column leaves a
    # |R[3, 3]| of ~1e-7, above the 1e-8 mask, on both sides alike
    deficient = random.astype(np.float64)
    deficient[:, 3] = 2.0 * deficient[:, 0] - deficient[:, 1]
    zero_col = random.copy()
    zero_col[:, 3] = 0.0
    return {"random": random, "rank1": rank1, "deficient": deficient, "zero_column": zero_col}


@pytest.mark.parametrize("case", sorted(_inputs()))
def test_orthogonalize_matches_jax(case):
    m = _inputs()[case]
    want = np.asarray(jax_orthogonalize(jnp.asarray(m)), np.float64)
    got = orthogonalize(torch.from_numpy(m)).double().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got @ got.T, want @ want.T, atol=PROJ_ATOL)
    zero_want = np.abs(want).max(axis=0) == 0
    zero_got = np.abs(got).max(axis=0) == 0
    np.testing.assert_array_equal(zero_got, zero_want)
    if case in ("zero_column", "deficient"):
        assert zero_got.sum() == 1


def _pair(n, dout, din, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, dout)).astype(np.float32),
            rng.normal(size=(n, din)).astype(np.float32))


def _product(br, cr):
    return np.asarray(br, np.float64).T @ np.asarray(cr, np.float64)


def test_power_iteration_with_injected_start_block_matches_jax():
    B, C = _pair(64, 24, 17)
    rank, iters = 6, 5
    key = jax.random.PRNGKey(3)
    jbr, jcr = jax_power_iteration_BC(jnp.asarray(B), jnp.asarray(C), key, rank=rank,
                                      iterations=iters)
    # the start block the JAX function draws from its key
    q0 = np.array(jax.random.normal(key, (24, rank), dtype=jnp.float32))
    br, cr = power_iteration_BC(torch.from_numpy(B), torch.from_numpy(C), rank=rank,
                                iterations=iters, q0=torch.from_numpy(q0))
    assert tuple(br.shape) == (rank, 24) and tuple(cr.shape) == (rank, 17)
    want = _product(jbr, jcr)
    np.testing.assert_allclose(_product(br, cr), want, atol=RTOL * np.abs(want).max())
    # a low-rank approximation of Bᵀ C, not the product itself
    assert np.abs(want - B.T.astype(np.float64) @ C).max() > 1e-3


@pytest.mark.parametrize("n,dout,din", [(5, 24, 9), (64, 4, 9)], ids=["n_le_rank", "dout_le_rank"])
def test_power_iteration_exact_branches_match_jax(n, dout, din):
    B, C = _pair(n, dout, din, seed=2)
    rank = 8
    jbr, jcr = jax_power_iteration_BC(jnp.asarray(B), jnp.asarray(C), jax.random.PRNGKey(0),
                                      rank=rank, iterations=5)
    br, cr = power_iteration_BC(torch.from_numpy(B), torch.from_numpy(C), rank=rank)
    assert tuple(br.shape) == np.asarray(jbr).shape and tuple(cr.shape) == np.asarray(jcr).shape
    exact = B.T.astype(np.float64) @ C
    tol = RTOL * np.abs(exact).max()
    np.testing.assert_allclose(_product(br, cr), exact, atol=tol)
    np.testing.assert_allclose(_product(jbr, jcr), exact, atol=tol)
    if n <= rank:  # the raw pair, zero-padded to rank rows
        np.testing.assert_array_equal(br.numpy(), np.asarray(jbr))
        np.testing.assert_array_equal(cr.numpy(), np.asarray(jcr))


def test_power_iteration_runs_in_float32_under_autocast():
    """Inside a bfloat16 autocast region the products stay float32."""
    B, C = _pair(64, 24, 17)
    q0 = torch.randn((24, 6), generator=torch.Generator().manual_seed(0))
    plain = power_iteration_BC(torch.from_numpy(B), torch.from_numpy(C), rank=6, q0=q0)
    with torch.autocast(device_type="cpu", dtype=torch.bfloat16):
        cast = power_iteration_BC(torch.from_numpy(B), torch.from_numpy(C), rank=6, q0=q0)
    for a, b in zip(plain, cast):
        assert b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
