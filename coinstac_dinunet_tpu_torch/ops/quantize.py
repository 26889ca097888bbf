"""Group-wise int8 quantization with stochastic rounding — the wire codec.

Port of the JAX package's ``ops/quantize.py``.  The flattened tensor is cut
into groups of 128; each group stores one float32 scale (absmax/127) and
128 int8 values rounded stochastically (floor, plus one with probability of
the fraction), so averaging many sites' quantized gradients stays unbiased.

Two implementations of one function, which quantizes the float leaves of
a wire payload into one int8 byte buffer laid out as the payload's data
section (leaf ``i``'s ``groups_i × 128`` int8 values, then its ``groups_i``
float32 scales, leaf after leaf):

- the CUDA kernel ``csrc/quantize_int8.cu`` (replacing the TPU kernel
  ``_quant_kernel``), one launch for up to :data:`MAX_SEGMENTS` leaves,
  taken for tensors on the card (:func:`quantize_int8_many`);
- :func:`quantize_int8_many_plain`, plain PyTorch on
  :func:`quantize_int8_plain`, taken for tensors on the CPU and used on the
  card only to check the kernel.

:func:`quantize_int8` is the same function for one tensor.

Both draw their noise from the same Philox4x32-10 stream — key
``(seed, 0)``, counter ``(group, lane, group >> 32, 0)`` with ``group``
counted within its leaf, lane ``l`` owning elements ``4l .. 4l+3`` of its
group — so they agree bit for bit on values and scales.  Against the JAX
package: the scales are bit-identical to its ``impl="numpy"`` path; the
values differ in which rounding noise they drew (numpy's PCG64 or the
TPU's PRNG there, Philox here) and agree in distribution: every value is
``floor`` or ``floor + 1`` of ``x/scale``.

Where the JAX package copies float32 gradients to the host and quantizes
there, the port quantizes a payload's leaves on the card in one launch and
copies only the int8 values and the scales, in one buffer; the payload
layout on the wire is unchanged.
"""
import ctypes

import numpy as np
import torch

from ._cuda import CudaKernel

GROUP = 128  # elements per scale group

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF

#: segments (payload leaves) one launch of the kernel takes: the table
#: travels as the kernel's parameter (``kMaxSegments`` in the source)
MAX_SEGMENTS = 64


class _Segment(ctypes.Structure):
    """One leaf in the kernel's segment table (``CoinnQuantizeSegment`` in
    the source)."""
    _fields_ = [("x", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("values", ctypes.c_longlong), ("scales", ctypes.c_longlong),
                ("seed", ctypes.c_uint)]


class _QuantizeKernel(CudaKernel):
    """K1: ``launches`` counts its launches, ``segments`` the leaves those
    launches quantized."""

    def __init__(self):
        super().__init__(
            "quantize_int8.cu", "coinn_quantize_int8_many",
            [ctypes.POINTER(_Segment), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
        )
        self.segments = 0


#: K1 on the card
KERNEL = _QuantizeKernel()


def _mulhilo(m, b):
    """(hi, lo) 32-bit words of the constant ``m`` times the uint32 words
    in int64 tensor ``b``.  The product needs 64 unsigned bits, which int64
    cannot hold, so ``b`` is split into 16-bit limbs: each partial product
    fits in 48 bits."""
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 over int64 tensors holding uint32 words; ``k0``/``k1``
    are Python ints.  Returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def random_bits(rows, seed, device):
    """The kernel's random words for ``rows`` groups: int64 ``(rows, 128)``
    holding uint32 values, element ``4l + j`` of a group taking word ``j``
    of lane ``l``'s Philox call."""
    g = torch.arange(rows, dtype=torch.int64, device=device).unsqueeze(1)
    lane = torch.arange(32, dtype=torch.int64, device=device).unsqueeze(0)
    c0 = (g & _MASK32).expand(rows, 32)
    c1 = lane.expand(rows, 32)
    c2 = (g >> 32).expand(rows, 32)
    c3 = torch.zeros_like(c0)
    words = philox4x32_10(c0, c1, c2, c3, int(seed) & _MASK32, 0)
    return torch.stack(words, dim=-1).reshape(rows, GROUP)


def quantize_int8_plain(groups, seed):
    """Plain PyTorch version of the kernel: float32 ``(rows, 128)`` →
    (int8 values ``(rows, 128)``, float32 scales ``(rows, 1)``).  Every
    division is tensor by tensor: PyTorch turns division by a Python scalar
    into multiplication by its reciprocal on the card, which is not the
    IEEE quotient the kernel computes."""
    absmax = groups.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(absmax / torch.full_like(absmax, 127.0), 1e-30)
    scaled = groups / scale
    lo = torch.floor(scaled)
    bits = random_bits(groups.shape[0], seed, groups.device)
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    vals = lo + (u < scaled - lo).to(torch.float32)
    vals = torch.nan_to_num(vals, nan=0.0).clamp(-127.0, 127.0)
    return vals.to(torch.int8), scale


def wire_layout(groups):
    """Where each leaf's bytes lie in the quantized data section, and its
    total size: leaf ``i`` takes ``groups[i] × 128`` bytes of int8 values,
    then ``groups[i] × 4`` bytes of float32 scales, leaf after leaf (every
    offset a multiple of 4).  Returns ``([(values slice, scales slice),
    ...], total bytes)``."""
    spans, off = [], 0
    for g in groups:
        mid, end = off + g * GROUP, off + g * (GROUP + 4)
        spans.append((slice(off, mid), slice(mid, end)))
        off = end
    return spans, off


def _flat(x):
    """``x`` as a contiguous float32 tensor, itself where it is one already
    (the kernel reads it flat, in memory order)."""
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.detach().to(torch.float32).contiguous()


def _leaf_device(leaves):
    devices = {x.device for x in leaves}
    if len(devices) != 1:
        raise ValueError(f"quantize_int8_many: leaves on several devices {devices}")
    return devices.pop()


def quantize_int8_many_plain(leaves, seeds):
    """Plain PyTorch version of :func:`quantize_int8_many`, on the leaves'
    device."""
    flats = [_flat(x).detach().reshape(-1) for x in leaves]
    rows = [-(-f.numel() // GROUP) for f in flats]
    spans, total = wire_layout(rows)
    out = torch.empty(total, dtype=torch.int8, device=_leaf_device(leaves) if leaves else None)
    for flat, r, (vs, ss), seed in zip(flats, rows, spans, seeds):
        if r == 0:
            continue
        groups = torch.nn.functional.pad(flat, (0, r * GROUP - flat.numel())).view(r, GROUP)
        vals, scales = quantize_int8_plain(groups, int(seed) % (2 ** 31))
        out[vs] = vals.reshape(-1)
        out[ss] = scales.reshape(-1).view(torch.int8)
    return out


def _segment_tables(flats, seeds):
    """The kernel's launches for the flat float32 leaves ``flats``: tables
    of at most :data:`MAX_SEGMENTS` ``(flat, values slice, scales slice,
    seed)`` in the output (:func:`wire_layout`), leaves without values left
    out; and the total bytes of the output."""
    spans, total = wire_layout([-(-f.numel() // GROUP) for f in flats])
    segs = [(f, vs, ss, int(seed) % (2 ** 31))
            for f, (vs, ss), seed in zip(flats, spans, seeds) if f.numel()]
    return [segs[i:i + MAX_SEGMENTS] for i in range(0, len(segs), MAX_SEGMENTS)], total


def _quantize_many_cuda(flats, seeds, device):
    # the kernel reads float4: a misaligned view is copied first.  The
    # tables keep every input alive until its launch has been enqueued.
    flats = [f if f.data_ptr() % 16 == 0 else f.clone() for f in flats]
    tables, total = _segment_tables(flats, seeds)
    out = torch.empty(total, dtype=torch.int8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for segs in tables:
            table = (_Segment * len(segs))(
                *[_Segment(f.data_ptr(), f.numel(), vs.start, ss.start, seed)
                  for f, vs, ss, seed in segs])
            KERNEL.launch(table, len(segs), out.data_ptr(), stream)
            KERNEL.segments += len(segs)
    return out


def quantize_int8_many(leaves, seeds):
    """Quantize float tensors of any shapes, all on one device, leaf ``i``
    with ``seeds[i]`` (modulo 2**31) → one int8 tensor on that device laid
    out as the wire's data section (:func:`wire_layout`).  On the card one kernel launch takes up to :data:`MAX_SEGMENTS`
    leaves (or raises); on the CPU the plain version runs."""
    leaves = list(leaves)
    seeds = list(seeds)
    if len(seeds) != len(leaves):
        raise ValueError(f"quantize_int8_many: {len(leaves)} leaves, {len(seeds)} seeds")
    if not leaves:
        return torch.empty(0, dtype=torch.int8)
    device = _leaf_device(leaves)
    if device.type == "cuda":
        return _quantize_many_cuda([_flat(x) for x in leaves], seeds, device)
    if device.type == "cpu":
        return quantize_int8_many_plain(leaves, seeds)
    raise ValueError(f"quantize_int8: unsupported device {device}")


def quantize_int8(x, seed=0):
    """Quantize a float tensor of any shape → ``(values int8 (rows, 128),
    scales float32 (rows, 1), shape)`` on ``x``'s device: views of
    :func:`quantize_int8_many` for one leaf.  ``seed`` is taken modulo
    2**31, as in the JAX package."""
    shape = tuple(x.shape)
    rows = -(-x.numel() // GROUP)
    if rows == 0:
        return (torch.zeros((0, GROUP), dtype=torch.int8, device=x.device),
                torch.zeros((0, 1), dtype=torch.float32, device=x.device),
                shape)
    buf = quantize_int8_many([x], [seed])
    (vs, ss), = wire_layout([rows])[0]
    return buf[vs].view(rows, GROUP), buf[ss].view(torch.float32).view(rows, 1), shape


def dequantize_int8(values, scales, shape):
    """Inverse of :func:`quantize_int8` on the host → float32 numpy array
    of ``shape`` (the receiving side of the wire)."""
    values = np.asarray(values, np.float32)
    scales = np.asarray(scales, np.float32)
    flat = (values * scales).reshape(-1)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return flat[:n].reshape(shape)
