"""``device_prefetch`` on the card: the copy stream and the cross-stream
lifetime of its batches.

The producer copies each batch on a stream of its own; the consumer's
stream waits on the batch's event, and every tensor is marked used by the
consumer's stream so the caching allocator does not hand its memory back
to the producer early.  A missing wait gives a wrong batch now and then, a
missing mark a corrupted one under memory pressure: here the consumer
writes into each batch and churns the allocator between batches, over 64
batches, and every batch must equal its host source.

There is no copy stream on the CPU, so every test here carries the
``cuda`` marker and skips without a card.  The file imports neither JAX
nor the JAX package:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_prefetch_card.py``.
"""
import numpy as np
import pytest
import torch

from coinstac_dinunet_tpu_torch.data import device_prefetch

N_BATCHES = 64


def _host_batches(seed=0, shape=(16, 32, 32, 32)):
    rng = np.random.default_rng(seed)
    for i in range(N_BATCHES):
        yield {"inputs": rng.normal(size=shape).astype(np.float32) + i,
               "labels": np.full(shape[0], i, np.int64),
               "_mask": np.ones(shape[0], np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("cast", [None, torch.bfloat16])
def test_prefetched_batches_equal_their_sources_under_allocator_churn(cast):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copy stream has no CPU mode")
    dev = torch.device("cuda")
    sources = list(_host_batches())
    seen = 0
    for i, batch in enumerate(device_prefetch(iter(sources), size=2, device=dev, cast=cast)):
        want = torch.from_numpy(sources[i]["inputs"])
        if cast is not None:
            want = want.to(cast)
        assert batch["inputs"].is_cuda and batch["inputs"].dtype == want.dtype
        # compare on the consumer's stream, then write into the batch and
        # free it while fresh allocations of the same size come and go
        assert torch.equal(batch["inputs"].cpu(), want), i
        assert torch.equal(batch["labels"].cpu(), torch.from_numpy(sources[i]["labels"])), i
        batch["inputs"].mul_(-3.0).add_(1.0)
        churn = [torch.empty_like(batch["inputs"]).fill_(float("nan")) for _ in range(3)]
        del churn, batch
        seen += 1
    assert seen == N_BATCHES


@pytest.mark.cuda
def test_prefetch_on_card_re_raises_and_passes_through():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def bad():
        yield {"inputs": np.zeros((2, 2), np.float32)}
        raise RuntimeError("loader died")

    it = device_prefetch(bad(), size=2, device="cuda")
    assert next(it)["inputs"].is_cuda
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)
    src = [{"inputs": np.zeros(3, np.float32)}]
    assert list(device_prefetch(iter(src), size=0))[0] is src[0]
