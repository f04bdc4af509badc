"""pycwt-torch — continuous wavelet analysis on PyTorch and CUDA (Hopper).

The PyTorch port of ``pycwt_tpu``: the same public names, signatures,
defaults and return contracts, with the hot loop of the forward transform
(filter bank × inverse FFT) as hand-written CUDA kernels for Hopper
(:mod:`pycwt_torch.ops.fused_cwt`) and everything else in plain PyTorch.
Entry points run on the card unless the caller passes ``device="cpu"``.

This slice ports the forward-CWT main path; the rest of
``pycwt_tpu/__init__.py``'s exports are listed in ``ROADMAP.md``.
"""

from . import mothers, sample  # noqa: F401
from .api import cwt, cwt_power, icwt  # noqa: F401
from .mothers import DOG, MexicanHat, Morlet, Paul  # noqa: F401
from .utils.helpers import boxpdf, find, get_cache_dir, rect  # noqa: F401

__all__ = [
    "cwt", "cwt_power", "icwt",
    "mothers", "Morlet", "Paul", "DOG", "MexicanHat",
    "find", "rect", "boxpdf", "get_cache_dir",
]
__version__ = "0.1.0"
