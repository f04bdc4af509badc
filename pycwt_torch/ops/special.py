"""Special functions: inverse regularized incomplete gamma and the
chi-square percent-point function.

Counterpart of ``pycwt_tpu/ops/special.py``.  The tensor functions run on
any device in the caller's dtype: a Wilson–Hilferty initial guess
(``torch.special.ndtri``) and a guarded Newton iteration on
``torch.special.gammainc``.  In f64 that incomplete gamma is up to ~2e-9
relative off scipy's for shapes a ≳ 20 (tests/test_torch_stats.py), so the
API-level significance scalars take the host float64 twins (stdlib plus
numpy, the JAX package's, copied as they are) through :func:`chi2_ppf_host`.
"""
from __future__ import annotations

import torch

__all__ = ["gammaincinv", "chi2_ppf", "chi2_ppf_np", "chi2_ppf_host"]


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=torch.float64)


def gammaincinv(a, p, *, iters: int = 40):
    """Inverse of the regularized lower incomplete gamma: solve P(a, x) = p.

    Parameters
    ----------
    a: shape parameter(s), > 0 (need not be integer — TC98 eq. 23/28 dofs are real).
    p: probability in (0, 1).
    iters: most Newton iterations (converges in < 10 for typical (a, p);
        the loop stops once every step is below 4 ulp).

    Tensors keep their dtype; other values (Python or numpy numbers) are
    taken as float64.  The result has the promoted dtype, at least float32.
    """
    a = _as_tensor(a)
    p = _as_tensor(p).to(a.device)
    dtype = torch.promote_types(torch.promote_types(a.dtype, p.dtype),
                                torch.float32)
    a = a.to(dtype)
    p = p.to(dtype)

    # Wilson–Hilferty: chi2_ppf(p, 2a)/2 ≈ a·(1 − 1/(9a) + z·sqrt(1/(9a)))³
    z = torch.special.ndtri(p)
    t = 1.0 - 1.0 / (9.0 * a) + z * torch.sqrt(1.0 / (9.0 * a))
    x = a * torch.clamp(t, min=1e-8) ** 3
    x = torch.clamp(x, min=torch.finfo(dtype).tiny * 1e8)

    log_gamma_a = torch.special.gammaln(a)
    eps = torch.finfo(dtype).eps
    for _ in range(iters):
        f = torch.special.gammainc(a, x) - p
        # P'(a, x) = x^(a−1)·e^(−x)/Γ(a)
        logpdf = (a - 1.0) * torch.log(x) - x - log_gamma_a
        x_new = x - f * torch.exp(-logpdf)
        # Guard: keep iterates positive; bisect toward 0 on overshoot.
        x_new = torch.where(torch.isfinite(x_new) & (x_new > 0), x_new, x * 0.5)
        done = bool(((x_new - x).abs() <= 4 * eps * x).all())
        x = x_new
        if done:
            break
    return x


def chi2_ppf(p, df):
    """Chi-square percent-point function (inverse CDF):
    ``chi2.ppf(p, df) == 2·gammaincinv(df/2, p)``."""
    return 2.0 * gammaincinv(_as_tensor(df) / 2.0, p)


# ----- host float64 twins (stdlib + numpy, as in the JAX package) -----

def _gser_np(a: float, x: float, itmax: int = 500,
             eps: float = 3e-16) -> float:
    """Series for the regularized lower incomplete gamma, x < a+1."""
    import math

    ap = a
    s = 1.0 / a
    delt = s
    for _ in range(itmax):
        ap += 1.0
        delt *= x / ap
        s += delt
        if abs(delt) < abs(s) * eps:
            break
    return s * math.exp(-x + a * math.log(x) - math.lgamma(a))


def _gcf_np(a: float, x: float, itmax: int = 500,
            eps: float = 3e-16) -> float:
    """Lentz continued fraction for the regularized UPPER gamma Q(a, x)."""
    import math

    tiny = 1e-300
    b = x + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / max(b, tiny)
    h = d
    for i in range(1, itmax):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        if abs(d) < tiny:
            d = tiny
        c = b + an / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < eps:
            break
    return math.exp(-x + a * math.log(x) - math.lgamma(a)) * h


def _gammainc_np_scalar(a: float, x: float) -> float:
    if x <= 0.0:
        return 0.0
    if x < a + 1.0:
        return _gser_np(a, x)
    return 1.0 - _gcf_np(a, x)


def _gammaincinv_np_scalar(a: float, p: float, iters: int = 60) -> float:
    import math
    import statistics

    # Wilson–Hilferty start (same as the tensor path); Newton's fixed point is
    # set by the f64 gammainc, so start accuracy only affects iteration
    # count.
    z = statistics.NormalDist().inv_cdf(p)
    t = 1.0 - 1.0 / (9.0 * a) + z * math.sqrt(1.0 / (9.0 * a))
    x = a * max(t, 1e-8) ** 3
    x = max(x, 1e-300)
    lg = math.lgamma(a)
    for _ in range(iters):
        f = _gammainc_np_scalar(a, x) - p
        logpdf = (a - 1.0) * math.log(x) - x - lg
        x_new = x - f * math.exp(-logpdf)
        if not (x_new > 0 and math.isfinite(x_new)):
            x_new = x * 0.5
        if abs(x_new - x) <= 1e-15 * x:
            x = x_new
            break
        x = x_new
    return x


def chi2_ppf_np(p, df):
    """Host float64 chi-square PPF in the stdlib alone — the twin of
    :func:`chi2_ppf` (matches scipy to ~1e-12 in f64; tested)."""
    import numpy as np

    fn = np.vectorize(lambda a, q: 2.0 * _gammaincinv_np_scalar(a / 2.0, q),
                      otypes=[np.float64])
    return fn(np.asarray(df, np.float64), np.asarray(p, np.float64))


def chi2_ppf_host(p, df):
    """Chi-square PPF (scalar or elementwise over arrays) in float64 on the
    host, as a numpy array: :func:`chi2_ppf_np`.  The one rule for every
    API-level significance scalar (``stats.significance``,
    ``coherence.xwt*``)."""
    return chi2_ppf_np(p, df)
