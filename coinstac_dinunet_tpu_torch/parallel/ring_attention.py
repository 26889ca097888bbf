"""Ring and Ulysses attention — sequence parallelism over a rank axis.

Port of the JAX package's ``parallel/ring_attention.py``.  Rank ``r`` of
the axis holds the contiguous block ``[r·T_local, (r+1)·T_local)`` of a
global sequence of ``T = n·T_local``.  In the JAX package each function
runs inside ``shard_map`` and sees its own rank's block; one controller
cannot write that per-rank signature, so here each function takes and
returns one block per rank: lists of ``(batch, heads, T_local, head_dim)``
tensors, rank ``r``'s on ``axis.devices[r]`` (:class:`~.mesh.RankAxis`).

Every attention call is :func:`~..ops.flash_attention.flash_attention`:
on a CUDA tensor the hand-written kernels K2 (forward) and K3/K4 (the
backward, through the ``FlashAttention`` autograd Function), on the CPU
their plain versions.

- :func:`ring_attention` — the blockwise ring of Liu et al.: for each of
  ``n`` hops every rank attends its queries to the key/value block in hand
  (one flash call with ``q_offset = r·T_local``, ``k_offset = src·T_local``
  and its log-sum-exp), merges the partial by the two lse's, and passes
  the block on to the next rank.  A block that the causal mask hides
  entirely (one from a later rank) reports the finite sentinel lse
  ``_NEG`` and zeros, and merges with weight 0: no NaN, and no
  data-dependent branch — ``n²`` flash calls a layer on an axis of ``n``,
  each backward taking a nonzero ``g_lse`` from the merge.
- :func:`ulysses_attention` — DeepSpeed-Ulysses: an all-to-all from
  sequence blocks to head blocks, one flash call a rank over the whole
  sequence for its ``heads/n`` heads, an all-to-all back.
"""
import torch

from ..ops.flash_attention import _NEG, flash_attention


def _merge(acc, lse, o_new, lse_new):
    """Combine two normalized softmax partials by their log-sum-exps."""
    m = torch.maximum(lse, lse_new)
    w1 = torch.exp(lse - m)
    w2 = torch.exp(lse_new - m)
    tot = torch.clamp_min(w1 + w2, 1e-30)
    out = (acc * w1[..., None] + o_new * w2[..., None]) / tot[..., None]
    return out, m + torch.log(tot)


def ring_attention(qs, ks, vs, axis, causal=False, scale=None):
    """Exact global attention over a sequence split over ``axis``.

    Args:
      qs, ks, vs: one ``(batch, heads, T_local, head_dim)`` block per rank
        of ``axis`` (rank ``r`` holds global positions ``[r·T_local,
        (r+1)·T_local)``), each on its rank's device.
      axis: the :class:`~.mesh.RankAxis` to ring over (the ``sp`` axis).
      causal, scale: forwarded to :func:`flash_attention`.

    Returns:
      one ``(batch, heads, T_local, head_dim)`` output block per rank, in
      the queries' dtype.
    """
    n = axis.size
    if not len(qs) == len(ks) == len(vs) == n:
        raise ValueError(f"ring_attention takes one block per rank of axis '{axis.name}' "
                         f"({n}), not {len(qs)}/{len(ks)}/{len(vs)}")
    b, h, t_local, _ = qs[0].shape
    accs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full((b, h, t_local), _NEG, dtype=torch.float32, device=q.device)
            for q in qs]
    kk, vv = list(ks), list(vs)
    for s in range(n):
        if s:
            # the blocks move one hop around the ring
            kk, vv = axis.ppermute(kk), axis.ppermute(vv)
        for r in range(n):
            src = (r - s) % n  # the rank the block in hand came from
            o_new, lse_new = flash_attention(
                qs[r], kk[r], vv[r], q_offset=r * t_local, k_offset=src * t_local,
                causal=causal, scale=scale, return_lse=True)
            accs[r], lses[r] = _merge(accs[r], lses[r], o_new.float(), lse_new)
    return [acc.to(q.dtype) for acc, q in zip(accs, qs)]


def ulysses_attention(qs, ks, vs, axis, causal=False, scale=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: arguments and
    result as :func:`ring_attention`'s; ``heads`` must be divisible by the
    axis size."""
    n = axis.size
    b, h, t_local, d = qs[0].shape
    if h % n != 0:
        raise ValueError(f"heads {h} must divide the '{axis.name}' axis size {n}")
    hn = h // n

    def seq_to_heads(xs):
        # rank j sends head block r of its sequence block to rank r, which
        # concatenates the blocks in source (= sequence) order
        got = axis.all_to_all([[x[:, r * hn:(r + 1) * hn] for r in range(n)] for x in xs])
        return [torch.cat(parts, dim=2) for parts in got]

    def heads_to_seq(xs):
        # rank r sends sequence block j of its heads to rank j, which
        # concatenates the head blocks in source order
        got = axis.all_to_all([[x[:, :, j * t_local:(j + 1) * t_local] for j in range(n)]
                               for x in xs])
        return [torch.cat(parts, dim=1) for parts in got]

    outs = [flash_attention(q, k, v, causal=causal, scale=scale)
            for q, k, v in zip(seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs))]
    return heads_to_seq(outs)
