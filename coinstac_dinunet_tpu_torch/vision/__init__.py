"""Vision extras (port of the JAX package's ``vision/``): training-curve
plotting (:func:`plot_progress`) and the image/patch utilities
(:mod:`.imageutils`).  Host code only."""
from . import imageutils  # noqa: F401
from .imageutils import *  # noqa: F401,F403 — everything in imageutils.__all__
from .imageutils import __all__ as _iu_all
from .plotter import plot_progress  # noqa: F401

__all__ = ["plot_progress", "imageutils", *_iu_all]
