"""pycwt-torch — continuous wavelet analysis on PyTorch and CUDA (Hopper).

The PyTorch port of ``pycwt_tpu``: the same public names, signatures,
defaults and return contracts, with the hot loop of the forward transform
(filter bank × inverse FFT) as hand-written CUDA kernels for Hopper
(:mod:`pycwt_torch.ops.fused_cwt`) and everything else in plain PyTorch.
Entry points run on the card unless the caller passes ``device="cpu"``.

Ported so far: the forward-CWT main path, the TC98 statistics, XWT, WCT and
its Monte-Carlo significance (single pair and batched), the many-pair
surfaces (``xwt_pairs``, ``xwt_pairs_planar``, ``wct_pairs``,
``wct_matrix``) and the single-device overlap-save long-signal transforms
(:mod:`pycwt_torch.ops.overlap`), parity mode on native float64
(``cwt_twofloat``, ``xwt_twofloat``, ``wct_twofloat``), and the profiling
and build-cache utilities (:mod:`pycwt_torch.utils.profiling`,
``utils.enable_compilation_cache``), and the multi-device surfaces
(:mod:`pycwt_torch.parallel`: ``torch.distributed`` ranks over a DeviceMesh,
``DTensor`` outputs), and the example workflows
(:mod:`pycwt_torch.examples`: ``python -m pycwt_torch.examples.sample_cwt``,
``.sample_xwt``, ``.sample_network``).
"""

from . import mothers, sample  # noqa: F401
from .api import cwt, cwt_power, icwt, significance  # noqa: F401
from .coherence import (wct, wct_matrix, wct_pairs, wct_significance,  # noqa: F401
                        wct_significance_batch, xwt,
                        xwt_pairs, xwt_pairs_planar, xwt_planar)
from .mothers import DOG, MexicanHat, Morlet, Paul  # noqa: F401
from .ops.twofloat import cwt_twofloat, wct_twofloat, xwt_twofloat  # noqa: F401
from .stats import ar1, ar1_batch, ar1_spectrum, rednoise  # noqa: F401
from .utils.helpers import boxpdf, find, get_cache_dir, rect  # noqa: F401

__all__ = [
    "cwt", "cwt_power", "icwt", "significance", "xwt", "xwt_pairs",
    "xwt_pairs_planar", "xwt_planar",
    "wct", "wct_matrix", "wct_pairs", "wct_significance",
    "wct_significance_batch", "cwt_twofloat", "xwt_twofloat", "wct_twofloat",
    "mothers", "Morlet", "Paul", "DOG", "MexicanHat",
    "ar1", "ar1_batch", "ar1_spectrum", "rednoise", "find", "rect", "boxpdf",
    "get_cache_dir",
]
__version__ = "0.1.0"
