"""Host-side helper utilities (API parity with reference ``pycwt/helpers.py``).

Counterpart of ``pycwt_tpu/utils/helpers.py``: small, inherently host/numpy
operations (index finding, rank transforms, cache paths), and the build
cache of the port's CUDA libraries.  The cache directory is the JAX
package's, so the two packages share their caches.

Reference bugs fixed here (documented, with the fixed behavior under test):

* ``boxpdf`` called a bare undefined ``interp`` (``helpers.py:223`` —
  NameError on every call).  We call ``np.interp``.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["find", "rect", "boxpdf", "get_cache_dir",
           "enable_compilation_cache"]


def find(condition):
    """Indices where ``ravel(condition)`` is true (reference ``helpers.py:37-40``)."""
    (res,) = np.nonzero(np.ravel(condition))
    return res


def rect(x, normalize: bool = False) -> np.ndarray:
    """Boxcar window with 0.5 end-weights (reference ``helpers.py:176-191``)."""
    if isinstance(x, (int, float)):
        shape = [int(x)]
    elif isinstance(x, (list, dict)):
        shape = x
    elif isinstance(x, np.ndarray):
        shape = x.shape
    else:
        raise TypeError(f"cannot build rect window from {type(x)}")
    X = np.zeros(shape)
    X[0] = X[-1] = 0.5
    X[1:-1] = 1
    if normalize:
        X /= X.sum()
    return X


def boxpdf(x):
    """Rank-transform data to an (approximately) uniform [0, 1] distribution
    (reference ``helpers.py:194-225``; their version crashes on the bare
    ``interp`` at :223 — fixed to ``np.interp``).

    Returns
    -------
    bX: transformed data.
    X, Y: the lookup table (unique values → box quantiles).
    """
    x = np.asarray(x)
    n = x.size
    i = np.argsort(x)
    d = np.diff(x[i]) != 0
    j = find(np.concatenate([d, [True]]))
    X = x[i][j]
    j = np.concatenate([[0], j + 1])
    Y = 0.5 * (j[0:-1] + j[1:]) / n
    bX = np.interp(x, X, Y)
    return bX, X, Y


def get_cache_dir() -> str:
    """Cache directory ``~/.cache/pycwt_tpu/`` (mkdir-if-missing), the same
    contract as the reference's ``~/.cache/pycwt/`` (``helpers.py:228-236``).
    Override with the ``PYCWT_TPU_CACHE_DIR`` environment variable."""
    cache_dir = os.environ.get(
        "PYCWT_TPU_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "pycwt_tpu"),
    )
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


def enable_compilation_cache(path: str | None = None) -> str:
    """Keep the port's compiled CUDA libraries in a persistent directory, so
    that ``nvcc`` runs once per machine and source, not once per checkout:
    the counterpart of the JAX package's persistent XLA cache.

    ``path`` defaults to ``<get_cache_dir()>/cuda_build`` (honors
    ``PYCWT_TPU_CACHE_DIR``); the directory is created and returned.  Safe
    to call more than once.  A later first load of each library
    (``ops/_build.py``) loads it from there, or builds it there when its
    source, headers or flags changed (the file name hashes them).  A library
    already loaded in this process stays loaded from where it was: call
    this before the first transform on the card.  Without a call, libraries
    build into ``pycwt_torch/_build/``.
    """
    from ..ops import _build

    if path is None:
        path = os.path.join(get_cache_dir(), "cuda_build")
    os.makedirs(path, exist_ok=True)
    _build.set_build_dir(path)
    return path
