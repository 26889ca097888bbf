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
  float32.  For float32 inputs K2 and K4 run on the tensor cores too, each
  float32 product as three TF32 products (``csrc/flash_attention_tf32.cuh``),
  and K3 computes in float32 on the CUDA cores.  They are instantiated for
  head dims 16, 32, 64 and 128; any other head dim up to 128 runs on the
  next of them, q, k, v and g_out zero-padded in the head dim and out, dq,
  dk, dv sliced back (:func:`padded_head_dim`; zero columns change no
  score).  Above 128, K2, K3 and K4 run on the tensor cores, on bfloat16
  inputs with the same roundings (``csrc/flash_attention_wide_wgmma.cuh``),
  on float32 inputs each float32 product as three TF32 products
  (``csrc/flash_attention_tf32.cuh``), at head dims 192, 256, 320, 384 and
  512, any head dim from 129 to 512 zero-padded to the next of them
  (:func:`wide_head_dim`, :func:`_kernel_head_dim`; :func:`kernel_route`
  names the kernels that run).  Above 512 all
  three run unpadded on the sliced kernels of
  ``csrc/flash_attention_wide.cuh`` (128-column slices of the head dim,
  each output slice written against a known lse), which compute on the
  CUDA cores and, on bfloat16 inputs, round ``g_out``, ``p`` and ``ds`` to
  bfloat16 before their second products as the tensor-core kernels do (K2
  ``p`` against the running max of its key tiles);
- :func:`flash_forward_plain` and :func:`flash_backward_plain`, plain
  PyTorch in float32 with autocast off (the dense form of the same
  identities, the counterparts of ``_flash_xla`` and the XLA backward),
  taken for tensors on the CPU and used on the card only to check the
  kernels.  Their ``round_dtype`` option gives them the bfloat16 kernels'
  roundings, for those checks only, at every head dim
  (:func:`rounds_at`).

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
#: d_model 64 over 4 heads); any head dim from 1 to the largest runs on the
#: next of them, q, k, v and g_out zero-padded in the head dim
#: (:func:`padded_head_dim`); above it see ``WIDE_HEAD_DIMS``
HEAD_DIMS = (16, 32, 64, 128)
#: head dims above ``HEAD_DIMS[-1]`` that K2, K3 and K4 run at on the
#: tensor cores (bfloat16 inputs: ``csrc/flash_attention_wide_wgmma.cuh``;
#: float32 inputs: ``csrc/flash_attention_tf32.cuh``): a head dim
#: from 129 to the largest runs on the next of them, zero-padded
#: (:func:`wide_head_dim`); head dims above the largest run on the sliced
#: kernels at their own width
WIDE_HEAD_DIMS = (192, 256, 320, 384, 512)
#: keys of a K/V tile of the bfloat16 forward kernel up to ``HEAD_DIMS[-1]``
#: (``Config<D>::kN`` in ``csrc/flash_attention_fwd_wgmma.cuh``): the tiles
#: over which its running max, and so its rounding of p, advances
FWD_KEY_TILE = 128
#: the same above it (``FwdConfig<D>::kN`` in
#: ``csrc/flash_attention_wide_wgmma.cuh``): a 64 x D float32 accumulator
#: leaves registers for a 64 x 64 score fragment only.  The float32 kernel
#: rounds nothing, so its own tile enters no plain version
WIDE_FWD_KEY_TILE = 64
#: the same at D = 384 and 512, where two 64-key stages would not fit in
#: shared memory beside the resident 128-row q tile
WIDEST_FWD_KEY_TILE = 32
#: the largest padded head dim of the 64-key forward tiles
WIDE_FWD_KEY_TILE_DIMS = 320
#: keys of a K/V tile of the bfloat16 K3 (``Config<D, true>::kN`` in
#: ``csrc/flash_attention_bwd_wgmma.cuh``, ``DqConfig<D>::kN`` and
#: ``DqSplitConfig<D>::kN`` in ``csrc/flash_attention_wide_wgmma.cuh``) up
#: to head dim 192; above it the tiles are halved: at 256 two 64 x 64 score
#: fragments would not fit in registers beside the 64 x 256 float32
#: accumulator, at 320 and 384 two stages of 64 keys not in shared memory
#: beside the resident q and g_out; at 512 (q and g_out 128 KB) two stages
#: of 32 keys do not fit either
DQ_KEY_TILE = 64
WIDE_DQ_KEY_TILE = 32
WIDEST_DQ_KEY_TILE = 16
#: keys of a K/V tile of the sliced kernels (``kTile`` in
#: ``csrc/flash_attention.cuh``): their K2 advances its running max over
#: these
SLICED_KEY_TILE = 64

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


def fwd_key_tile(d):
    """Keys of a K/V tile of the bfloat16 forward kernel that runs a head
    dim ``d`` (the tiles its running max advances over)."""
    if d <= HEAD_DIMS[-1]:
        return FWD_KEY_TILE
    dim = wide_head_dim(d)
    if dim is None:
        return SLICED_KEY_TILE
    return WIDE_FWD_KEY_TILE if dim <= WIDE_FWD_KEY_TILE_DIMS else WIDEST_FWD_KEY_TILE


def dq_key_tile(d):
    """Keys of a K/V tile of the bfloat16 K3 that runs a head dim ``d``."""
    if d > WIDE_HEAD_DIMS[-1]:
        return SLICED_KEY_TILE
    if d <= WIDE_HEAD_DIMS[0]:
        return DQ_KEY_TILE
    return WIDEST_DQ_KEY_TILE if d > WIDE_HEAD_DIMS[-2] else WIDE_DQ_KEY_TILE


def rounds_at(d, dq=False):
    """Whether the bfloat16 kernel at head dim ``d`` rounds its operands to
    bfloat16 as the TPU's matrix unit does: K2, K3 (``dq``) and K4 at every
    head dim, the tensor-core kernels and the sliced ones alike.  ``dq``
    names the kernel a check asks about; the answer is the same for all
    three."""
    return True


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

    ``round_dtype`` serves the checks of the bfloat16 kernels only, no
    path of the port: it is the dtype those kernels round ``p`` to before
    P·V (bfloat16).  With it, ``scale`` multiplies the float32 product as in
    the kernel instead of ``q``, and ``p`` is the online softmax's: the keys
    go in tiles of ``FWD_KEY_TILE``, ``p`` is taken against the running
    row max after each tile and rounded there, and each tile's share is
    rescaled to the final max in float32, as the kernel's accumulator is;
    ``l`` sums the unrounded ``p``.  The key tile is the kernel's at the
    head dim (:func:`fwd_key_tile`).  ``None`` is the float32 statement of
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
    """:func:`flash_forward_plain` with the bfloat16 kernels' arithmetic:
    scores in log2 units (``scale·log2 e`` times the float32 product, the
    sentinel after the scale), the running max over key tiles, ``p`` rounded
    to ``round_dtype`` against it."""
    bh, tq, d = q.shape
    tk, n = k.shape[1], fwd_key_tile(d)
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

    ``round_dtype`` serves the checks of the bfloat16 kernels only, no
    path of the port: it is the dtype those kernels round ``g_out``, ``p``
    and ``ds`` to before their products (bfloat16), and with it ``scale``
    multiplies the float32 products as in the kernels instead of ``q``.
    ``None`` is the float32 statement of the function.
    """
    bh, tq, d = q.shape
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


def padded_head_dim(d):
    """The head dim a head dim ``d`` runs at: up to ``HEAD_DIMS[-1]`` the
    smallest instantiated one (``HEAD_DIMS``) that holds it, above it ``d``
    itself (the sliced kernels take any width; the tensor-core kernels
    there pad to :func:`wide_head_dim` instead).  Zero columns change no
    score ``q·k`` and add nothing to ``p·v``, so the kernel's output, lse
    and gradients in the first ``d`` columns are those of the unpadded call
    (given the unpadded head dim's scale); the padded columns are
    dropped."""
    if d > HEAD_DIMS[-1]:
        return d
    for dim in HEAD_DIMS:
        if 1 <= d <= dim:
            return dim
    raise ValueError(f"flash attention kernels take head dims of 1 or more, not {d}")


def wide_head_dim(d):
    """The head dim the tensor-core kernels above ``HEAD_DIMS[-1]`` (K2, K3
    and K4 of both types) run at for a head dim ``d``: the
    smallest of ``WIDE_HEAD_DIMS`` that holds it, or ``None`` above the
    largest (the sliced kernels, at ``d`` itself).  Zero-padded as
    :func:`padded_head_dim` says."""
    return next((dim for dim in WIDE_HEAD_DIMS if HEAD_DIMS[-1] < d <= dim), None)


def _kernel_head_dim(d, dtype, kernel=FWD_KERNEL):
    """The head dim ``kernel`` (``FWD_KERNEL``, ``DQ_KERNEL`` or
    ``DKV_KERNEL``) runs at on inputs of ``dtype``: up to ``HEAD_DIMS[-1]``
    :func:`padded_head_dim`, above it :func:`wide_head_dim` (the
    tensor-core kernels), and ``d`` itself above ``WIDE_HEAD_DIMS[-1]``
    (the sliced kernels).  The same for every dtype and kernel; a caller
    names the ones it asks about."""
    if d > HEAD_DIMS[-1]:
        return wide_head_dim(d) or d
    return padded_head_dim(d)


def kernel_route(d, dtype, kernel=FWD_KERNEL):
    """Which hand-written kernels run ``kernel`` (``FWD_KERNEL``,
    ``DQ_KERNEL`` or ``DKV_KERNEL``) at head dim ``d`` on inputs of
    ``dtype``, as ``csrc/flash_attention_{fwd,bwd}.cu`` dispatch:
    ``"wgmma"`` (bfloat16 on the tensor cores), ``"tf32"`` (float32 on the
    tensor cores, three TF32 products a float32 product), ``"cuda_cores"``
    (float32 K3 up to ``HEAD_DIMS[-1]``) or ``"sliced"`` (every kernel above
    ``WIDE_HEAD_DIMS[-1]``)."""
    if d > WIDE_HEAD_DIMS[-1]:
        return "sliced"
    if dtype == torch.bfloat16:
        return "wgmma"
    if kernel is DQ_KERNEL and d <= HEAD_DIMS[-1]:
        return "cuda_cores"
    return "tf32"


def _pad_head_dim(t, dim):
    """``t`` zero-padded in its last axis to ``dim`` columns, contiguous."""
    d = t.shape[-1]
    return (t if d == dim else torch.nn.functional.pad(t, (0, dim - d))).contiguous()


def _check_cuda(q, k, v):
    d = q.shape[-1]
    padded_head_dim(d)
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
    """K2 on the card; same contract as :func:`flash_forward_plain`, at any
    head dim (:func:`padded_head_dim`)."""
    _check_cuda(q, k, v)
    bh, tq, d = q.shape
    dim = _kernel_head_dim(d, q.dtype)
    q, k, v = (_pad_head_dim(t, dim) for t in (q, k, v))
    out = torch.empty((bh, tq, dim), dtype=torch.float32, device=q.device)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or k.shape[1] == 0:  # no key: every row fully masked
        return out[..., :d].zero_(), lse.fill_(_NEG)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          lse.data_ptr(), *_shape_args(q, k, (q_offset, k_offset, kv_len),
                                                       causal, scale, stream))
    return (out if dim == d else out[..., :d].contiguous()), lse


def _bwd_cuda(kernel, out_rows, q, k, v, g_out, lse, delta, g_lse, q_offset,
              k_offset, kv_len, causal, scale):
    """One backward kernel: float32 outputs of ``(bh, rows, d)`` for each
    of ``out_rows``, computed at the kernel's head dim and sliced back."""
    _check_cuda(q, k, v)
    d = q.shape[-1]
    dim = _kernel_head_dim(d, q.dtype, kernel)
    ins = [_pad_head_dim(t, dim) for t in (q, k, v)]
    # g_out in the inputs' dtype: the bfloat16 kernels round it there
    ins += [_pad_head_dim(g_out.to(q.dtype), dim)]
    ins += [t.float().contiguous() for t in (lse, delta, g_lse)]
    outs = [torch.empty((q.shape[0], rows, dim), dtype=torch.float32, device=q.device)
            for rows in out_rows]
    if q.numel() == 0 or k.numel() == 0:
        return [o[..., :d].zero_() for o in outs]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel.launch(*(t.data_ptr() for t in ins + outs),
                      *_shape_args(ins[0], ins[1], (q_offset, k_offset, kv_len), causal,
                                   scale, stream))
    return [o if dim == d else o[..., :d].contiguous() for o in outs]


def flash_dq_cuda(q, k, v, g_out, lse, delta, g_lse, *args):
    """K3 on the card; same contract as :func:`flash_dq_plain`."""
    return _bwd_cuda(DQ_KERNEL, [q.shape[1]], q, k, v, g_out, lse, delta, g_lse, *args)[0]


def flash_dkv_cuda(q, k, v, g_out, lse, delta, g_lse, *args):
    """K4 on the card; same contract as :func:`flash_dkv_plain`."""
    return tuple(_bwd_cuda(DKV_KERNEL, [k.shape[1]] * 2, q, k, v, g_out, lse, delta, g_lse,
                           *args))


def flash_backward_cuda(q, k, v, out, lse, g_out, g_lse, q_offset, k_offset,
                        kv_len, causal, scale):
    """K3 then K4 on the card; same contract as
    :func:`flash_backward_plain`."""
    # Δ from the float32 cotangent; one cast of g_out serves both launches,
    # which take it in the inputs' dtype at every head dim
    g = g_out.to(q.dtype)
    rest = (lse, flash_delta(out, g_out), g_lse, q_offset, k_offset, kv_len, causal, scale)
    return (flash_dq_cuda(q, k, v, g, *rest), *flash_dkv_cuda(q, k, v, g, *rest))


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


# shapes alone, for ``meta`` tensors: the ranks another process computes
# (``parallel/hosts.py``) run the program on them, launching nothing
@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_offset, k_offset, kv_len, causal, scale):
    return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty(q.shape[:2], dtype=torch.float32, device=q.device))


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, g_out, g_lse, q_offset, k_offset, kv_len, causal,
                    scale):
    return tuple(torch.empty(t.shape, dtype=torch.float32, device=t.device) for t in (q, k, v))


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


# ---- the derived bound of the tensor-core kernels' roundings (checks only)
#
# A per-element bound on how far the bfloat16 tensor-core kernels (K2, K3,
# K4) may lie from their rounding-matched function; it serves the checks of
# those kernels (chip_smoke.py phase 3, the tests), no path of the port.
# The kernels round p (K2, K4) and ds (K3, K4) to bfloat16 before their
# second products.  Their float32 p and ds differ from any other float32
# computation of the same function in the last bits (the tensor cores sum
# the scores in their own order, ex2.approx against exp), so a value that
# lies close to a bfloat16 rounding boundary may round the other way and
# move by one bfloat16 step.  A fixed ratio of the output's largest
# magnitude cannot hold that at every length and head dim; this bound
# counts it instead:
#  - the reference is the rounding-matched function in float64: scores,
#    softmax, p and ds exact but for float64's own rounding, p and ds
#    rounded to bfloat16 through float32 (as the kernels round their float32
#    values), the second products in float64;
#  - eps, per element, is how far the kernel's float32 p or ds may lie from
#    the exact value, from the kernel's arithmetic step by step
#    (tc_dot_error for the tensor-core sums of S and dP; float32 rounding of
#    each scale, subtraction and product; ex2.approx's relative error);
#  - an element within eps of a bfloat16 rounding boundary may round to the
#    other side: one bfloat16 step.  The bound on an output element is the
#    sum over such elements of that step times the magnitude of the other
#    operand of the product (|v|, |g_out|, |k|, |q|), in exact arithmetic.
# The float32 sums of the second products and the softmax's rescaling are
# not in it: the caller adds the float32 term of its tolerance (FLASH_RTOL
# times the reference's largest magnitude).  The derivation, with the
# numbers it gives, is in CHANGES.md.
# The sliced kernels (every bfloat16 kernel above 512) round the same values the same way; their scores are float32 fma chains
# on the CUDA cores over q·scale rounded once, one rounding of at most 2^-24
# of the running sum a term, which the tensor-core model (17 roundings of
# 2^-23 a 16-deep step) covers, and their expf errs by less than ex2.approx.

#: float32's unit roundoff (round to nearest)
_U = 2.0 ** -24
#: a tensor-core accumulation step: float32's last bit, truncated
_U_TC = 2.0 ** -23
#: relative error of ``ex2.approx.ftz.f32`` (2 ulp), with a margin of 2
_EXP2_REL = 2.0 ** -21
#: width of the probabilistic bound on a tensor-core sum: an element's sum
#: leaves it with probability at most 2·exp(-λ²/2) = 3e-8
BOUND_LAMBDA = 6.0
#: significand bits (with the implicit one) of the rounding dtypes
_SIGNIFICAND = {torch.bfloat16: 8, torch.float16: 11}
#: score elements a chunk of the bound's float64 work holds at once
_BOUND_CHUNK_ELEMS = 2 ** 24


def tc_dot_error(a, b):
    """``(err, exact)`` for ``a·bᵀ`` over the last axis, ``(..., Ta, Tb)``
    each, float64: ``exact`` the product, ``err`` a bound on how far a
    tensor-core kernel's float32 sum of it lies from ``exact``.

    The kernels sum over the head dim in 16-deep slices in order (one wgmma
    instruction each).  Each step adds 16 exact products (bfloat16 times
    bfloat16 fits float32) to the accumulator and rounds, or truncates, at
    most 17 times; each such error is at most ``_U_TC`` times the step's
    largest intermediate, itself at most ``|P| + A``: ``P`` the partial sum
    before the slice, ``A`` the slice's sum of ``|products|``.  Taken as
    independent and of mean zero (the probabilistic model of Higham and
    Mary, 2019), they sum to at most ``λ·_U_TC·sqrt(17·Σ (|P| + A)²)``
    (λ = ``BOUND_LAMBDA``), with probability at least ``1 - 2·exp(-λ²/2)``
    an element."""
    a, b = a.double(), b.double().transpose(-1, -2)
    exact = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64, device=a.device)
    sq = torch.zeros_like(exact)
    for s0 in range(0, a.shape[-1], 16):
        a_s, b_s = a[..., s0:s0 + 16], b[..., s0:s0 + 16, :]
        sq += (exact.abs() + a_s.abs() @ b_s.abs()) ** 2
        exact += a_s @ b_s
    return BOUND_LAMBDA * _U_TC * torch.sqrt(17.0 * sq), exact


def near_rounding_boundary(x, eps, dtype=torch.bfloat16):
    """``(rounded, step)`` for float64 ``x``: ``x`` rounded to ``dtype``
    through float32, as a kernel rounds its float32 values, and, where
    ``x`` lies within ``eps`` of a rounding boundary of ``dtype``, the step
    a rounding to the other side makes (0 elsewhere and at 0)."""
    _, ex = torch.frexp(x.abs())  # |x| = m·2^ex, m in [0.5, 1)
    spacing = torch.ldexp(torch.ones_like(x), ex - _SIGNIFICAND[dtype])
    r = x.abs() / spacing
    near = ((r - r.floor() - 0.5).abs() * spacing <= eps) & (x != 0)
    return x.float().to(dtype).double(), torch.where(near, spacing, 0.0)


def rounding_bound_forward(q, k, v, q_offset, k_offset, kv_len, causal, scale,
                            round_dtype=torch.bfloat16):
    """``(want, bound)``, ``(BH, Tq, d)`` float32 each, for K2 on bfloat16
    ``q``, ``k``, ``v``: ``want`` the rounding-matched forward in float64
    (the online softmax over the kernel's key tiles, ``p`` rounded to
    ``round_dtype`` against the running max), ``bound`` per output element
    the sum of one step of each ``p`` near a boundary times ``|v|``, over
    ``l``.

    The kernel's ``p = 2^(t − m)``: ``t = c·s``, ``c = scale·log2 e``
    rounded to float32 and the product rounded (2u|t| beside c·err(s)); the
    running max ``m`` off by at most the largest error of a ``t`` so far;
    the subtraction u|t − m|; ``ex2.approx`` relative ``_EXP2_REL``; so
    ``eps(p) = p·(ln 2·(err(t) + err(m) + u|t − m|) + _EXP2_REL)``."""
    bh, tq, d = q.shape
    tk, n = k.shape[1], fwd_key_tile(d)
    nt = -(-tk // n)
    valid = _valid_mask(tq, tk, q_offset, k_offset, kv_len, causal, q.device)
    c = scale * _LOG2E
    vf = v.double()

    def tiles(x, fill):  # (.., Tk) -> (.., key tiles, n), padded with `fill`
        return torch.nn.functional.pad(x, (0, nt * n - tk), value=fill).unflatten(-1, (nt, n))

    wants, bounds = [], []
    for sl in _chunks(bh, tq, nt * n, _BOUND_CHUNK_ELEMS):
        err_s, s = tc_dot_error(q[sl], k[sl])
        t = torch.where(valid, s * c, _NEG)
        err_t = torch.where(valid, err_s * c + 2 * _U * t.abs(), 0.0)
        t, err_t = tiles(t, _NEG), tiles(err_t, 0.0)
        m_run = t.amax(dim=-1).cummax(dim=-1).values  # the max after each tile
        err_m = err_t.amax(dim=-1).cummax(dim=-1).values
        x = t - m_run.unsqueeze(-1)
        p = torch.exp2(x)
        err_p = p * (_LN2 * (err_t + err_m.unsqueeze(-1) + _U * x.abs()) + _EXP2_REL)
        pr, step = near_rounding_boundary(p, err_p, round_dtype)
        m = m_run[..., -1]
        rescale = torch.exp2(m_run - m.unsqueeze(-1)).unsqueeze(-1)  # each tile to the final max
        l = torch.clamp_min((p * rescale).sum(dim=(-2, -1)), 1e-30).unsqueeze(-1)
        untile = lambda x: (x * rescale).flatten(-2)[..., :tk]
        ok = (m > _MASKED_LSE).unsqueeze(-1)
        wants.append(torch.where(ok, untile(pr) @ vf[sl] / l, 0.0))
        bounds.append(torch.where(ok, untile(step) @ vf[sl].abs() / l, 0.0))
    return torch.cat(wants).float(), torch.cat(bounds).float()


def rounding_bound_backward(q, k, v, g_out, lse, delta, g_lse, q_offset, k_offset, kv_len,
                            causal, scale, dq=True, round_dtype=torch.bfloat16):
    """``(wants, bounds)`` for K3 (``dq``: one each, ``(BH, Tq, d)``) or K4
    (two each: dk and dv, ``(BH, Tk, d)``), float32, on bfloat16 ``q``,
    ``k``, ``v`` and a ``g_out`` the kernels take in bfloat16 (cast once,
    so the same on both sides): ``want`` the rounding-matched backward in
    float64 (``p`` and ``ds`` rounded to ``round_dtype``), ``bound`` the sum
    of one step of each ``p`` (dv) or ``ds`` (dq, dk) near a boundary times
    ``|g_out|``, ``scale·|k|`` or ``scale·|q|``.

    The kernels' ``p = 2^(fma(s, c, −λ))`` with ``c = scale·log2 e`` and
    ``λ = lse·log2 e`` rounded to float32: ``err(x) = c·err(s) + 2u|c·s| +
    u|λ| + u|x|``, ``eps(p) = p·(ln 2·err(x) + _EXP2_REL)``; ``y = dp − σ``
    with ``σ = Δ − g_lse`` rounded (u|σ|) and the subtraction (u|y|), and
    ``ds = p·y`` rounded (u|ds|): ``eps(ds) = eps(p)·|y| + p·(err(dp) +
    u|σ| + u|y|) + u|ds|``."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    valid = _valid_mask(tq, tk, q_offset, k_offset, kv_len, causal, q.device)
    c = scale * _LOG2E
    qf, kf = q.double(), k.double()
    go = g_out.to(torch.bfloat16).double()
    lam2 = torch.where(lse <= _MASKED_LSE, 0.0, lse.double()) * _LOG2E
    sub = delta.double() - g_lse.double()
    outs = []
    for sl in _chunks(bh, tq, tk, _BOUND_CHUNK_ELEMS):
        err_s, s = tc_dot_error(q[sl], k[sl])
        err_dp, dp = tc_dot_error(go[sl], v[sl])
        la, su = lam2[sl].unsqueeze(-1), sub[sl].unsqueeze(-1)
        x = s * c - la
        p = torch.where(valid, torch.exp2(x), 0.0)
        err_x = err_s * c + 2 * _U * (s * c).abs() + _U * la.abs() + _U * x.abs()
        err_p = p * (_LN2 * err_x + _EXP2_REL)
        y = dp - su
        ds = p * y
        err_ds = err_p * y.abs() + p * (err_dp + _U * su.abs() + _U * y.abs()) + _U * ds.abs()
        dsr, ds_step = near_rounding_boundary(ds, err_ds, round_dtype)
        if dq:
            outs.append(((dsr @ kf[sl]) * scale, (ds_step @ kf[sl].abs()) * scale))
        else:
            pr, p_step = near_rounding_boundary(p, err_p, round_dtype)
            dst, ds_stept = dsr.transpose(1, 2), ds_step.transpose(1, 2)
            outs.append(((dst @ qf[sl]) * scale, pr.transpose(1, 2) @ go[sl],
                         (ds_stept @ qf[sl].abs()) * scale, p_step.transpose(1, 2) @ go[sl].abs()))
    cols = [torch.cat(x).float() for x in zip(*outs)]
    half = len(cols) // 2
    return cols[:half], cols[half:]


def bound_excess(got, want, bound, rtol, atol):
    """The largest ``|got − want| / (bound + rtol·max|want| + atol)`` over
    the elements: at most 1 when ``got`` keeps to the bound."""
    if not got.numel():
        return 0.0
    tol = bound.double() + rtol * float(want.abs().max()) + atol
    return float(((got.double() - want.double()).abs() / tol).max())


def bound_share(bound, want):
    """``max(bound) / max|want|``: how much of the output the flips the
    bound allows could be worth, for the report (0 for an output of
    zeros)."""
    top = float(want.abs().max()) if want.numel() else 0.0
    return float(bound.max()) / top if top > 0 else 0.0
