"""Classification loss and the ``iteration`` output dict (port of the JAX
package's ``metrics/loss.py::cross_entropy``/``classification_outputs``).
Everything here runs in float32, whatever the compute dtype.

The port adds the per-sample path the site-vectorized federation needs
(``federation/vector.py``): :func:`sample_nll` is the unreduced loss, and
``classification_outputs`` returns it as ``"sample_loss"`` beside the
masked mean, so a batch that folds several sites' samples together can be
reduced per site."""
import torch


def sample_nll(logits, labels):
    """Softmax cross-entropy per element over integer labels, unreduced
    (shape of ``labels``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)


def masked_mean(nll, mask=None):
    """``sum(nll * mask) / max(sum(mask), 1)``; a per-sample ``mask``
    over a per-element ``nll`` weighs every element of its sample."""
    if mask is None:
        return nll.mean()
    m = mask.to(torch.float32)
    if m.shape == nll.shape:
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    m = m.reshape(m.shape[0], *([1] * (nll.ndim - 1)))
    denom = torch.sum(m) * (nll.numel() / nll.shape[0])
    return torch.sum(nll * m) / torch.clamp_min(denom, 1.0)


def cross_entropy(logits, labels, mask=None):
    """Mean softmax cross-entropy over integer labels, padding-masked:
    ``sum(nll * mask) / max(sum(mask), 1)``."""
    return masked_mean(sample_nll(logits, labels), mask)


def classification_outputs(logits, labels, mask=None):
    """``{"loss", "sample_loss", "pred", "true"}`` (+ ``"prob"``, the
    positive-class probability, for a binary head); ``sample_loss`` is the
    unmasked per-element loss whose masked mean is ``loss``."""
    nll = sample_nll(logits, labels)
    it = {
        "loss": masked_mean(nll, mask),
        "sample_loss": nll,
        "pred": torch.argmax(logits, -1),
        "true": labels,
    }
    if logits.shape[-1] == 2:
        it["prob"] = torch.softmax(logits.float(), dim=-1)[..., 1]
    return it
