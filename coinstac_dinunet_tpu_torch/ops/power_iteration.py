"""Low-rank compression math: subspace power iteration + orthogonalization
(PyTorch port).

Port of the JAX package's ``ops/power_iteration.py``, which holds no Pallas
kernel: the matrix products and the QR stay plain torch ops
(``torch.linalg.qr``, ``@``) on whatever device the inputs live on.

Math.  Given paired matrices ``B (N, dout)`` and ``C (N, din)`` (per-layer
output gradients and input activations; ``A = Bᵀ C`` is the weight
gradient), block power iteration on ``A Aᵀ`` never materializes ``A`` or
the ``N×N`` Gram matrix::

    Q ← orth( Bᵀ (C (Cᵀ (B Q))) )

then ships ``Br = Qᵀ (r, dout)`` and ``Cr = (B Q)ᵀ C (r, din)`` with
``Brᵀ Cr = Q Qᵀ A ≈ A``.

What differs from the JAX package:

- **float32, autocast off.**  Everything is computed in float32 with
  autocast disabled: inside a trainer's bfloat16 ``torch.autocast`` region
  these products would otherwise run in bfloat16, where the JAX package
  computes them in float32.
- **The random start block** comes from a ``torch.Generator`` (``q0``
  injects it), not from a JAX PRNG key: threefry cannot be reproduced in
  torch, so the two packages start the iteration from different blocks.
"""
import torch
import torch.nn.functional as F


def float32_math(device):
    """The context the compression math runs in: autocast off on
    ``device``'s type (the callers cast to float32 themselves)."""
    return torch.autocast(device_type=torch.device(device).type, enabled=False)


def orthogonalize(m, eps=1e-8):
    """Column-orthonormalize ``m (n, r)`` (requires ``n >= r``).

    The rank-1 fast path is a plain normalize; otherwise reduced QR.
    Columns of (near-)zero norm come out as zero columns: the columns QR
    makes up for rank-deficient input are masked by ``|diag(R)| > eps``."""
    if m.ndim != 2:
        raise ValueError(f"orthogonalize expects a matrix, got shape {tuple(m.shape)}")
    with float32_math(m.device):
        if m.shape[1] == 1:
            return m / torch.clamp_min(torch.linalg.norm(m), eps)
        q, r = torch.linalg.qr(m)
        keep = (torch.diagonal(r).abs() > eps).to(m.dtype)
        return q * keep[None, :]


def power_iteration_BC(B, C, generator=None, rank=10, iterations=5, q0=None):
    """Joint low-rank factors ``(Br (r, dout), Cr (r, din))`` of the pair
    ``B (N, dout)``, ``C (N, din)`` with ``Brᵀ Cr ≈ Bᵀ C``; see the module
    docstring.

    Exact (zero-padded to rank ``r``) whenever the pair's rank is ≤ r: if
    ``N <= rank`` the raw pair ships; if ``dout <= rank`` the identity
    basis ships with ``Bᵀ C``.  Otherwise ``iterations`` fixed block
    iterations from the start block ``q0 (dout, rank)``, drawn from
    ``generator`` (a CPU ``torch.Generator``; None takes torch's default)
    when not given, then moved to ``B``'s device."""
    with float32_math(B.device):
        B = B.to(torch.float32)
        C = C.to(torch.float32)
        n, dout = B.shape
        if n <= rank:
            # nothing to compress: ship the raw pair, padded to rank rows
            return F.pad(B, (0, 0, 0, rank - n)), F.pad(C, (0, 0, 0, rank - n))
        if dout <= rank:
            # output space smaller than rank: the identity basis is exact
            eye = torch.eye(dout, dtype=B.dtype, device=B.device)
            return F.pad(eye, (0, 0, 0, rank - dout)), F.pad(B.T @ C, (0, 0, 0, rank - dout))
        if q0 is None:
            q0 = torch.randn((dout, rank), generator=generator, dtype=torch.float32)
        Q = orthogonalize(q0.to(device=B.device, dtype=torch.float32))
        for _ in range(int(iterations)):
            # (A Aᵀ) Q with A = Bᵀ C, associated to stay in N- and r-wide products
            Q = orthogonalize(B.T @ (C @ (C.T @ (B @ Q))))
        return Q.T, (B @ Q).T @ C
