"""Training-curve plotting: the port of the JAX package's
``vision/plotter.py``.

``log_header`` convention: ``|``-separated sub-plot groups, each group a
``,``-separated list of column names — e.g. ``"loss|precision,recall,f1"``
plots loss alone and the three scores together.  One PNG per log key,
``<log_dir>/<key>.png``, drawn on the host with matplotlib's Agg backend.

What differs from the JAX package, whose plotter imports matplotlib
unguarded: where matplotlib does not import, :func:`plot_progress` draws
nothing — it logs that once per process and writes one ``plot:skipped``
event on the ambient recorder — and the run goes on; the CSV and JSON logs
are the same either way.
"""
import os

import numpy as np

from ..telemetry.recorder import get_active as _telemetry
from ..utils import logger

_SKIP_REPORTED = False


def _rolling_mean(x, w):
    if len(x) < 2 * w:
        return None
    kernel = np.ones(w) / w
    return np.convolve(x, kernel, mode="valid")


def _epoch_ticks(n_rows, epoch, max_ticks=10):
    """(tick positions, labels) relabeling the row axis in epoch numbers
    (≙ ref ``vision/plotter.py:51-60``), thinned to ``max_ticks``.

    Works in both directions: more rows than epochs (several log rows per
    epoch) and fewer rows than epochs (``validation_epochs > 1`` — row i is
    epoch ``(i+1)·epoch/n_rows``).
    """
    step = max(int(np.ceil(n_rows / max_ticks)), 1)
    positions = list(range(0, n_rows, step))
    labels = []
    for p in positions:
        e = (p + 1) * float(epoch) / n_rows
        labels.append(int(round(e)) if abs(e - round(e)) < 1e-9 else round(e, 1))
    return positions, labels


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib
    does not import (reported once per process)."""
    global _SKIP_REPORTED
    try:
        import matplotlib

        matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt
    except ImportError as exc:
        if not _SKIP_REPORTED:
            _SKIP_REPORTED = True
            logger.warn(f"training curves not plotted: {exc}")
            _telemetry().event("plot:skipped", cat="plot", reason=f"{type(exc).__name__}: {exc}")
        return None
    return plt


def plot_progress(cache, log_dir=None, plot_keys=("train_log",), epoch=None):
    """Render raw + rolling-mean curves for every key's accumulated rows;
    returns the paths of the PNGs written ([] where matplotlib does not
    import).

    ``epoch``: when given and different from the row count, x-ticks are
    remapped so labels read in epochs rather than log rows."""
    plt = _pyplot()
    if plt is None:
        return []
    log_dir = log_dir or cache.get("log_dir", ".")
    os.makedirs(log_dir, exist_ok=True)
    header = cache.get("log_header", "loss")
    groups = [
        [c.strip() for c in grp.split(",") if c.strip()]
        for grp in header.split("|")
    ]
    written = []
    for key in plot_keys:
        rows = cache.get(key, [])
        if len(rows) < 2:
            continue
        data = np.asarray([list(np.ravel(r)) for r in rows], dtype=float)
        ncols = data.shape[1]
        # assign columns to groups left-to-right; spill into the last group
        fig, axes = plt.subplots(
            1, len(groups), figsize=(6 * len(groups), 4), squeeze=False
        )
        col = 0
        for gi, grp in enumerate(groups):
            ax = axes[0][gi]
            take = grp if gi < len(groups) - 1 else grp + [
                f"col{c}" for c in range(col + len(grp), ncols)
            ]
            for name in take:
                if col >= ncols:
                    break
                series = data[:, col]
                ax.plot(series, alpha=0.4, label=name)
                rm = _rolling_mean(series, max(len(series) // 10, 2))
                if rm is not None:
                    ax.plot(
                        np.arange(len(series) - len(rm), len(series)), rm,
                        linewidth=2,
                    )
                col += 1
            if epoch and int(epoch) != len(rows) and int(epoch) > 0:
                ticks, labels = _epoch_ticks(len(rows), epoch)
                ax.set_xticks(ticks)
                ax.set_xticklabels(labels)
                ax.set_xlabel("epoch")
            else:
                ax.set_xlabel("epoch" if "log" in key else "step")
            ax.legend(loc="best", fontsize=8)
            ax.grid(alpha=0.3)
        fig.tight_layout()
        path = os.path.join(log_dir, f"{key}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written
