"""The port's GroupNorm (``coinstac_dinunet_tpu_torch.ops.groupnorm``)
against the JAX package's ``group_norm`` and its VJP (the closed-form
backward), on the same numpy inputs (the JAX op takes channels last, the
port channels first).

Tolerances: float32 forward and gradients max |Δ| ≤ 2e-5·max|ref| (the
two sum the statistics in different orders); bfloat16 (the JAX op's input
and output in bfloat16, float32 inside, as in the port) ≤ 1 bfloat16 ulp
of the largest value, 2⁻⁷·max|ref|, on the output and ≤ 2e-2·max|ref| on
the gradients.  The fused layer against the plain one inside the port:
2e-5·max at float32 (on the card, under bfloat16 autocast, the fused
layer returns bfloat16 and the plain one float32, one rounding apart).  ``gradcheck`` at float64 on a (2, 4, 3, 3) input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu.ops.groupnorm import group_norm as jax_group_norm
from coinstac_dinunet_tpu_torch.ops import groupnorm as gn_module
from coinstac_dinunet_tpu_torch.ops.groupnorm import NormReLU, group_norm, norm_relu

SHAPE = (3, 16, 5, 6, 4)  # (B, C, D, H, W)


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    c = shape[1]
    scale = (1.0 + 0.3 * rng.normal(size=c)).astype(np.float32)
    bias = (0.2 * rng.normal(size=c)).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, dy


def _jax(x, scale, bias, dy, groups, relu, dtype):
    """JAX forward and VJP on the channels-last transpose, returned in the
    channels-first layout as float32 numpy."""
    last = (0, *range(2, x.ndim), 1)
    first = (0, x.ndim - 1, *range(1, x.ndim - 1))
    xj = jnp.asarray(np.transpose(x, last)).astype(dtype)
    dyj = jnp.asarray(np.transpose(dy, last)).astype(dtype)
    y, vjp = jax.vjp(lambda a, s, b: jax_group_norm(a, s, b, groups, relu=relu),
                     xj, jnp.asarray(scale), jnp.asarray(bias))
    dx, ds, db = vjp(dyj)
    as_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return (np.transpose(as_np(y), first), np.transpose(as_np(dx), first),
            as_np(ds), as_np(db))


def _port(x, scale, bias, dy, groups, relu, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = group_norm(xt, st, bt, groups, relu=relu)
    y.backward(torch.from_numpy(dy).to(dtype))
    f = lambda t: t.detach().float().numpy()  # noqa: E731
    return f(y), f(xt.grad), f(st.grad), f(bt.grad)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_vjp_match_jax(relu, dtype):
    x, scale, bias, dy = _inputs(1 + relu)
    want = _jax(x, scale, bias, dy, 8, relu, getattr(jnp, dtype))
    got = _port(x, scale, bias, dy, 8, relu, getattr(torch, dtype))
    if dtype == "float32":
        _close(got, want, 2e-5)
    else:
        # the JAX op rounds its input and output to bfloat16, as the port's
        # does; the outputs differ by at most one rounding
        _close(got[:1], want[:1], 2.0 ** -7)
        _close(got[1:], want[1:], 2e-2)
    assert got[0].shape == x.shape


@pytest.mark.parametrize("relu", [False, True])
def test_fused_matches_plain_within_the_port(relu):
    x, scale, bias, dy = _inputs(7, (4, 16, 9, 7))
    outs = []
    for fused in (True, False):
        m = NormReLU(16, fused=fused, relu=relu)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(x).requires_grad_()
        y = m(xt)
        y.backward(torch.from_numpy(dy))
        outs.append([t.detach().numpy() for t in (y, xt.grad, m.weight.grad, m.bias.grad)])
    _close(outs[0], outs[1], 2e-5)


def test_kill_switch_and_parameters(monkeypatch):
    """``COINN_NO_FUSED_GN`` at construction makes a fused layer plain; the
    fused and plain layers carry the same parameters; the fused layer
    returns the input's dtype, with float32 statistics inside."""
    fused, plain = norm_relu(4, True, relu=False), norm_relu(4, False, relu=False)
    assert [(n, tuple(p.shape)) for n, p in fused.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in plain.named_parameters()] == \
        [("weight", (4,)), ("bias", (4,))]
    assert fused.groups == 4 and norm_relu(32).groups == 8
    x = torch.randn(2, 4, 3, 3, dtype=torch.bfloat16)
    assert fused(x).dtype == torch.bfloat16
    calls = []
    monkeypatch.setattr(gn_module, "group_norm", lambda x, *a: calls.append(a) or x)
    fused(x)
    assert len(calls) == 1
    monkeypatch.setenv("COINN_NO_FUSED_GN", "1")
    killed = norm_relu(4, True, relu=False)
    assert not killed.fused and fused.fused
    killed(x.float())
    assert len(calls) == 1


def test_indivisible_channels_raise():
    x = torch.zeros(2, 6, 4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        group_norm(x, torch.ones(6), torch.zeros(6), 4)
    with pytest.raises(ValueError, match="not divisible"):
        jax_group_norm(jnp.zeros((2, 4, 4, 6)), jnp.ones(6), jnp.zeros(6), 4)


@pytest.mark.parametrize("relu", [False, True])
def test_gradcheck_float64(relu):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
    s = (1 + 0.3 * torch.randn(4, generator=g, dtype=torch.float64)).requires_grad_()
    b = (0.2 * torch.randn(4, generator=g, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, c, d: group_norm(a, c, d, 2, relu=relu),
                                    (x, s, b), eps=1e-6, atol=1e-6)
