"""Fused blockwise (flash) attention — the port of the JAX package's
``ops/flash_attention.py``.

The contract is the JAX function's: ``(out, lse)`` over ``(B, H, T, d)``
queries/keys/values, masks computed from the int32 positions ``(q_offset,
k_offset, kv_len)`` and an optional causal mask, float32 softmax state
whatever the input dtype, and a finite sentinel ``_NEG`` instead of
``-inf``: a row with every key masked emits zeros and ``lse ≈ -1e30``,
which a log-sum-exp merge annihilates.

Two implementations of each direction:

- the CUDA kernels, launched for tensors on the card: K2
  ``csrc/flash_attention_fwd.cu`` (replacing the TPU kernel
  ``_flash_kernel``), K3 and K4 ``csrc/flash_attention_bwd.cu``
  (replacing ``_dq_kernel`` and ``_dkv_kernel``).  For bfloat16 inputs all
  three run every tile product on the tensor cores
  (``csrc/flash_attention_fwd_wgmma.cuh``,
  ``csrc/flash_attention_bwd_wgmma.cuh``): ``p`` in the forward, and
  ``g_out``, ``p`` and ``ds`` in the backward, are rounded to bfloat16
  before the products, whose sums are float32, as on the TPU's matrix unit;
  the softmax state (row max, row sum, the output accumulator) stays
  float32.  For float32 inputs all three compute in float32 on the CUDA
  cores;
- :func:`flash_forward_plain` and :func:`flash_backward_plain`, plain
  PyTorch in float32 with autocast off (the dense form of the same
  identities, the counterparts of ``_flash_xla`` and the XLA backward),
  taken for tensors on the CPU and used on the card only to check the
  kernels.  Their ``round_dtype`` option gives them the tensor-core
  kernels' bfloat16 roundings, for those checks only.

:class:`FlashAttention` is the ``torch.autograd.Function`` over
``(BH, T, d)``: it returns float32 ``(out, lse)`` and takes a cotangent for
both (the ``g_lse`` term of ``ds = p·(dp − Δ + g_lse)``).  The cast of
``out`` to the input dtype happens outside it, as in the JAX package, and
``Δ = Σ g_out·out`` is a plain reduction on the float32 ``out``.

Each direction runs as an operator of its own, ``torch.ops.coinn.flash_fwd``
and ``torch.ops.coinn.flash_bwd``, with a formula for
``torch.utils.flop_counter``: a ``FlopCounterMode`` counts a call's model
FLOPs from its shapes (:func:`attention_flops`) and none of the plain
version's products inside it, so the count of a step is the same on the
card, where the counter cannot see the kernels, and on the CPU.

There is no ``impl`` switch: the device of the tensors decides.  A value of
``attn_impl`` carried over from a JAX configuration (``'pallas'``,
``'xla'``, ...) is refused by the model, never mapped to the plain version.
"""
import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from ._cuda import CudaKernel

_NEG = -1.0e30  # finite "-inf": keeps exp/max NaN-free for fully masked rows
_MASKED_LSE = _NEG / 2  # an lse at or below this marks a fully masked row
_LSE_PAD = 1.0e30  # lse of a q row past Tq: exp(s - pad) == 0
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453

#: head dims the kernels are instantiated for (16: the sequence example's
#: d_model 64 over 4 heads)
HEAD_DIMS = (16, 32, 64, 128)
#: keys of a K/V tile of the bfloat16 forward kernel at every head dim
#: (``Config<D>::kN`` in ``csrc/flash_attention_fwd_wgmma.cuh``): the tiles
#: over which its running max, and so its rounding of p, advances
FWD_KEY_TILE = 128

_ARGS = [ctypes.c_void_p] * 3  # q, k, v
_SHAPE = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# (bh, tq, tk, d, is_bf16, scale, causal, q_offset, k_offset, kv_len, stream)

#: K2 on the card (``FWD_KERNEL.launches`` counts its launches)
FWD_KERNEL = CudaKernel("flash_attention_fwd.cu", "coinn_flash_fwd",
                        _ARGS + [ctypes.c_void_p] * 2 + _SHAPE)
#: K3: dq with the keys streaming
DQ_KERNEL = CudaKernel("flash_attention_bwd.cu", "coinn_flash_bwd_dq",
                       _ARGS + [ctypes.c_void_p] * 5 + _SHAPE)
#: K4: dk and dv with the queries streaming
DKV_KERNEL = CudaKernel("flash_attention_bwd.cu", "coinn_flash_bwd_dkv",
                        _ARGS + [ctypes.c_void_p] * 6 + _SHAPE)

KERNELS = (FWD_KERNEL, DQ_KERNEL, DKV_KERNEL)


def _valid_mask(tq, tk, q_offset, k_offset, kv_len, causal, device):
    """``(tq, tk)`` key-validity (and causal) mask from global positions,
    in int64 so no offset overflows."""
    rows = q_offset + torch.arange(tq, dtype=torch.int64, device=device)
    cols = torch.arange(tk, dtype=torch.int64, device=device)
    valid = (cols < kv_len).unsqueeze(0).expand(tq, tk)
    if causal:
        valid = valid & (rows.unsqueeze(1) >= k_offset + cols.unsqueeze(0))
    return valid


def _chunks(bh, tq, tk, max_elems=2 ** 28):
    """Slices of the ``bh`` axis whose ``(tq, tk)`` score tiles hold at
    most ``max_elems`` values together (each ``bh`` is independent)."""
    step = max(1, max_elems // max(1, tq * tk))
    return [slice(i, min(bh, i + step)) for i in range(0, bh, step)]


def flash_forward_plain(q, k, v, q_offset, k_offset, kv_len, causal, scale,
                        round_dtype=None):
    """Plain PyTorch version of K2: ``(BH, Tq, d)``, ``(BH, Tk, d)`` →
    ``(out (BH, Tq, d) float32, lse (BH, Tq) float32)``.

    ``round_dtype`` serves the checks of the tensor-core kernel only, no
    path of the port: it is the dtype that kernel rounds ``p`` to before
    P·V (bfloat16).  With it, ``scale`` multiplies the float32 product as in
    the kernel instead of ``q``, and ``p`` is the online softmax's: the keys
    go in tiles of ``FWD_KEY_TILE``, ``p`` is taken against the running
    row max after each tile and rounded there, and each tile's share is
    rescaled to the final max in float32, as the kernel's accumulator is;
    ``l`` sums the unrounded ``p``.  ``None`` is the float32 statement of
    the function.
    """
    bh, tq, _ = q.shape
    valid = _valid_mask(tq, k.shape[1], q_offset, k_offset, kv_len, causal, q.device)
    if round_dtype is not None:
        return _forward_online(q, k, v, valid, scale, round_dtype)
    outs, lses = [], []
    with torch.autocast(device_type=q.device.type, enabled=False):
        for sl in _chunks(bh, tq, k.shape[1]):
            s = torch.matmul(q[sl].float() * scale, k[sl].float().transpose(1, 2))
            s = torch.where(valid, s, _NEG)
            m = s.amax(dim=-1)
            p = torch.exp(s - m.unsqueeze(-1))
            l = torch.clamp_min(p.sum(dim=-1), 1e-30)
            out = torch.matmul(p / l.unsqueeze(-1), v[sl].float())
            # fully masked rows emit zeros (not mean(V)); their lse keeps
            # the sentinel
            outs.append(torch.where((m > _MASKED_LSE).unsqueeze(-1), out, 0.0))
            lses.append(m + torch.log(l))
    return torch.cat(outs), torch.cat(lses)


def _forward_online(q, k, v, valid, scale, round_dtype):
    """:func:`flash_forward_plain` with the tensor-core kernel's arithmetic:
    scores in log2 units (``scale·log2 e`` times the float32 product, the
    sentinel after the scale), the running max over key tiles, ``p`` rounded
    to ``round_dtype`` against it."""
    bh, tq, _ = q.shape
    tk, n = k.shape[1], FWD_KEY_TILE
    nt = -(-tk // n)
    outs, lses = [], []
    with torch.autocast(device_type=q.device.type, enabled=False):
        for sl in _chunks(bh, tq, nt * n):
            t = torch.matmul(q[sl].float(), k[sl].float().transpose(1, 2)) * (scale * _LOG2E)
            t = torch.nn.functional.pad(torch.where(valid, t, _NEG), (0, nt * n - tk),
                                        value=_NEG).unflatten(-1, (nt, n))
            m_run = t.amax(dim=-1).cummax(dim=-1).values  # the max after each tile
            p = torch.exp2(t - m_run.unsqueeze(-1))
            m = m_run[..., -1]
            rescale = torch.exp2(m_run - m.unsqueeze(-1))  # each tile to the final max
            l = torch.clamp_min((p.sum(dim=-1) * rescale).sum(dim=-1), 1e-30)
            pr = (p.to(round_dtype).float() * rescale.unsqueeze(-1)).flatten(-2)[..., :tk]
            out = torch.matmul(pr, v[sl].float()) / l.unsqueeze(-1)
            ok = m > _MASKED_LSE
            outs.append(torch.where(ok.unsqueeze(-1), out, 0.0))
            lses.append(torch.where(ok, m * _LN2 + torch.log(l), _NEG))
    return torch.cat(outs), torch.cat(lses)


def flash_delta(out, g_out):
    """``Δ = Σ_d g_out·out`` per row, from the float32 ``out`` (a plain
    reduction, as the JAX package computes it outside its kernels)."""
    with torch.autocast(device_type=out.device.type, enabled=False):
        return (g_out.float() * out.float()).sum(dim=-1)


def _backward_plain(q, k, v, g_out, lse, delta, g_lse, q_offset, k_offset,
                    kv_len, causal, scale, dq=True, dkv=True, round_dtype=None):
    """The dense backward over ``bh`` chunks, in float32 with autocast off:
    ``(dq or None, dk or None, dv or None)``.

    ``round_dtype`` serves the checks of the tensor-core kernels only, no
    path of the port: it is the dtype those kernels round ``g_out``, ``p``
    and ``ds`` to before their products (bfloat16), and with it ``scale``
    multiplies the float32 products as in the kernels instead of ``q``.
    ``None`` is the float32 statement of the function.
    """
    bh, tq, _ = q.shape
    valid = _valid_mask(tq, k.shape[1], q_offset, k_offset, kv_len, causal, q.device)
    matched = round_dtype is not None
    rnd = (lambda t: t.to(round_dtype).float()) if matched else (lambda t: t)
    dqs, dks, dvs = [], [], []
    with torch.autocast(device_type=q.device.type, enabled=False):
        lse_safe = torch.where(lse <= _MASKED_LSE, 0.0, lse.float())
        for sl in _chunks(bh, tq, k.shape[1]):
            qf = q[sl].float() if matched else q[sl].float() * scale
            kf, vf, go = k[sl].float(), v[sl].float(), rnd(g_out[sl].float())
            s = torch.matmul(qf, kf.transpose(1, 2))
            if matched:
                s = s * scale
            p = torch.where(valid, torch.exp(torch.where(valid, s, _NEG)
                                             - lse_safe[sl].unsqueeze(-1)), 0.0)
            dp = torch.matmul(go, vf.transpose(1, 2))
            ds = p * (dp - delta[sl].float().unsqueeze(-1) + g_lse[sl].float().unsqueeze(-1))
            p, ds = rnd(p), rnd(ds)
            if dq:
                dqs.append(torch.matmul(ds, kf) * scale)
            if dkv:
                dk = torch.matmul(ds.transpose(1, 2), qf)
                dks.append(dk * scale if matched else dk)
                dvs.append(torch.matmul(p.transpose(1, 2), go))
    return tuple(torch.cat(x) if x else None for x in (dqs, dks, dvs))


def flash_dq_plain(*args, round_dtype=None):
    """Plain PyTorch version of K3, ``dq = scale·ds·k`` (float32), from
    ``(q, k, v, g_out, lse, Δ, g_lse, q_offset, k_offset, kv_len, causal,
    scale)``; ``round_dtype`` as in :func:`_backward_plain`."""
    return _backward_plain(*args, dkv=False, round_dtype=round_dtype)[0]


def flash_dkv_plain(*args, round_dtype=None):
    """Plain PyTorch version of K4, ``dk = dsᵀ·(scale·q)`` and ``dv =
    pᵀ·g_out`` (float32), from the arguments of :func:`flash_dq_plain`."""
    return _backward_plain(*args, dq=False, round_dtype=round_dtype)[1:]


def flash_backward_plain(q, k, v, out, lse, g_out, g_lse, q_offset, k_offset,
                         kv_len, causal, scale):
    """Plain PyTorch version of K3 and K4: the flash backward identities in
    dense form, ``ds = p·(dp − Δ + g_lse)``.  Returns float32 ``(dq, dk,
    dv)``."""
    return _backward_plain(q, k, v, g_out, lse, flash_delta(out, g_out), g_lse,
                           q_offset, k_offset, kv_len, causal, scale)


def _check_cuda(q, k, v):
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head dims {HEAD_DIMS}, not {d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention kernels take float32 or bfloat16, not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash attention kernels need q, k and v of one dtype")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != d:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.shape[0] > 65535:  # the grid's y dimension
        raise ValueError(f"flash attention kernels take at most 65535 batch·heads, not {q.shape[0]}")


def _shape_args(q, k, pos, causal, scale, stream):
    bh, tq, d = q.shape
    q_offset, k_offset, kv_len = pos
    return (bh, tq, k.shape[1], d, int(q.dtype == torch.bfloat16), float(scale),
            int(causal), q_offset, k_offset, kv_len, stream)


def flash_forward_cuda(q, k, v, q_offset, k_offset, kv_len, causal, scale):
    """K2 on the card; same contract as :func:`flash_forward_plain`."""
    _check_cuda(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, tq, d = q.shape
    out = torch.empty((bh, tq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or k.shape[1] == 0:  # no key: every row fully masked
        return out.zero_(), lse.fill_(_NEG)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          lse.data_ptr(), *_shape_args(q, k, (q_offset, k_offset, kv_len),
                                                       causal, scale, stream))
    return out, lse


def _bwd_cuda(kernel, outs, q, k, v, g_out, lse, delta, g_lse, q_offset,
              k_offset, kv_len, causal, scale):
    _check_cuda(q, k, v)
    ins = [t.contiguous() for t in (q, k, v)]
    # the bfloat16 kernels take g_out in bfloat16 (their products run on
    # bfloat16 tiles), the float32 kernels in float32
    ins += [g_out.to(q.dtype).contiguous()]
    ins += [t.float().contiguous() for t in (lse, delta, g_lse)]
    if q.numel() == 0 or k.numel() == 0:
        return [o.zero_() for o in outs]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel.launch(*(t.data_ptr() for t in ins + outs),
                      *_shape_args(q, k, (q_offset, k_offset, kv_len), causal, scale, stream))
    return outs


def flash_dq_cuda(q, k, v, g_out, lse, delta, g_lse, *args):
    """K3 on the card; same contract as :func:`flash_dq_plain`."""
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    return _bwd_cuda(DQ_KERNEL, [dq], q, k, v, g_out, lse, delta, g_lse, *args)[0]


def flash_dkv_cuda(q, k, v, g_out, lse, delta, g_lse, *args):
    """K4 on the card; same contract as :func:`flash_dkv_plain`."""
    outs = [torch.empty(k.shape, dtype=torch.float32, device=q.device) for _ in range(2)]
    return tuple(_bwd_cuda(DKV_KERNEL, outs, q, k, v, g_out, lse, delta, g_lse, *args))


def flash_backward_cuda(q, k, v, out, lse, g_out, g_lse, q_offset, k_offset,
                        kv_len, causal, scale):
    """K3 then K4 on the card; same contract as
    :func:`flash_backward_plain`."""
    # Δ from the float32 cotangent; one cast of g_out serves both launches
    args = (q, k, v, g_out.to(q.dtype), lse, flash_delta(out, g_out), g_lse, q_offset,
            k_offset, kv_len, causal, scale)
    return (flash_dq_cuda(*args), *flash_dkv_cuda(*args))


def _dispatch(t, cuda_fn, plain_fn):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"flash attention: unsupported device {t.device}")


def attention_flops(bh, tq, tk, d, backward=False):
    """Model FLOPs of one attention call over ``bh`` (batch × heads) rows:
    the forward's two products, ``4·BH·Tq·Tk·d`` (K2), or the backward's
    four, ``8·BH·Tq·Tk·d`` (K3 + K4).  The full ``Tq × Tk`` rectangle
    whatever the masks (no causal halving), and no recompute of ``S`` in
    the backward: the work of the function, not of one schedule."""
    return (8 if backward else 4) * int(bh) * int(tq) * int(tk) * int(d)


# The two directions as operators of their own (``torch.ops.coinn``): a
# ``FlopCounterMode`` counts each call once from its shapes (the formulas
# below) and does not descend into it, so the count is the same whether the
# call launched K2–K4 (invisible to the counter) or ran the plain version's
# products on the CPU.
@torch.library.custom_op("coinn::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
                  k_offset: int, kv_len: int, causal: bool,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    fwd = _dispatch(q, flash_forward_cuda, flash_forward_plain)
    return fwd(q, k, v, q_offset, k_offset, kv_len, causal, scale)


@torch.library.custom_op("coinn::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                  lse: torch.Tensor, g_out: torch.Tensor, g_lse: torch.Tensor,
                  q_offset: int, k_offset: int, kv_len: int, causal: bool,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    bwd = _dispatch(q, flash_backward_cuda, flash_backward_plain)
    return bwd(q, k, v, out, lse, g_out, g_lse, q_offset, k_offset, kv_len, causal, scale)


@register_flop_formula(torch.ops.coinn.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, *args, **kwargs):
    return attention_flops(q_shape[0], q_shape[1], k_shape[1], q_shape[2])


@register_flop_formula(torch.ops.coinn.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, **kwargs):
    return attention_flops(q_shape[0], q_shape[1], k_shape[1], q_shape[2], backward=True)


class FlashAttention(torch.autograd.Function):
    """``(q, k, v)`` of shape ``(BH, T, d)`` → float32 ``(out, lse)``, with
    the positions as int32 scalars and a cotangent for both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, kv_len, causal, scale):
        out, lse = torch.ops.coinn.flash_fwd(q, k, v, q_offset, k_offset, kv_len,
                                             causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, k_offset, kv_len, causal, scale)
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        if g_lse is None:
            g_lse = torch.zeros_like(lse)
        dq, dk, dv = torch.ops.coinn.flash_bwd(q, k, v, out, lse, g_out, g_lse, *ctx.args)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def _int32(x, name):
    x = int(x)
    if not -2 ** 31 <= x < 2 ** 31:
        raise ValueError(f"{name}={x} does not fit in int32")
    return x


def flash_attention(q, k, v, q_offset=0, k_offset=0, kv_len=None, causal=False,
                    scale=None, return_lse=False):
    """Fused scaled-dot-product attention.

    Args:
      q: ``(batch, heads, Tq, head_dim)`` queries (float32 or bfloat16).
      k, v: ``(batch, heads, Tk, head_dim)`` keys/values.
      q_offset, k_offset: global position of row/col 0 — the causal mask is
        ``q_offset + i >= k_offset + j``.  int32 scalars.
      kv_len: number of valid keys (default ``Tk``); keys past it are masked.
      causal: apply the causal mask.
      scale: score scale (default ``1/sqrt(head_dim)``).
      return_lse: also return the per-row log-sum-exp ``(batch, heads, Tq)``
        (float32).

    Returns:
      ``out (batch, heads, Tq, head_dim)`` in ``q.dtype``; optionally
      ``(out, lse)``.
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pos = (_int32(q_offset, "q_offset"), _int32(k_offset, "k_offset"),
           _int32(tk if kv_len is None else kv_len, "kv_len"))
    out, lse = FlashAttention.apply(
        q.reshape(b * h, tq, d), k.reshape(b * h, tk, d), v.reshape(b * h, tk, d),
        *pos, bool(causal), float(scale))
    out = out.reshape(b, h, tq, d).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b, h, tq)
    return out
