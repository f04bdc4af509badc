"""Fused filter bank × four-step inverse FFT: the forward CWT's hot loop.

Counterpart of ``pycwt_tpu/ops/pallas_fft.py``.  Its two Pallas TPU kernels
(``_make_kernel_a`` and ``_make_kernel_b``) become the hand-written CUDA
kernels ``cwt_stage_a`` and ``cwt_stage_b`` in ``csrc/fused_cwt.cu``,
compiled for Hopper at first use (``ops/_build.py``).  With N = R2·R1,
k = b·R1 + a and t = c + R2·d:

    stage A:  T[a, c] = e^{2πi·ac/N} Σ_b X[b·R1 + a]·H̄_s[b·R1 + a] e^{2πi·bc/R2}
    stage B:  W[c + R2·d] = (1/N) Σ_a T[a, c] e^{2πi·ad/R1}

Each kernel runs its length-R2 (stage A) or length-R1 (stage B) columns as a
Stockham FFT of 16 points per thread with the radices of
:func:`_column_radix_plan`, which the wrapper passes and the kernel checks;
:func:`_column_stockham` replays those passes for the tests.

Precision tiers.  ``highest`` and ``high`` run the kernels with an f32
intermediate T.  ``fast`` stores T in bf16, as ``pycwt_tpu`` does at its
fast tier (``pallas_fft.py:699-705``): stage A rounds T to nearest even and
stage B widens it back to f32, which halves T's round trip through device
memory.  The bf16 forms are the entries ``cwt_stage_a_bf16`` and
``cwt_stage_b_bf16``, counted apart in :data:`KERNEL_LAUNCHES`; T's points
are counted by type in ``profiling.T_BF16_POINTS`` and ``T_F32_POINTS``.

Epilogues (``output``).  ``cwt_stage_b`` ends in W planes (``"planes"``),
complex64 W (``"complex"``: one interleaved store a point, the layout of a
complex tensor, so that :func:`fused_cwt` returns it with no assembly pass),
|W|² (``"power"``) or Σ_t |W|² (``"power_sum"``).  Its launches in the
complex epilogue are counted in :data:`STAGE_B_COMPLEX_LAUNCHES` as well.

Dispatch: a CPU tensor runs the plain PyTorch version
(:func:`_fused_cwt_planar_reference`, the bank × X then ``torch.fft.ifft``;
at ``fast`` the two stages' plain versions with a bf16 T); a CUDA tensor
runs the kernels, or the call raises; any other device raises.  The
kernels' gradient replays the f32 plain version at every tier
(:class:`_FusedCWT`), as the JAX package's ``_with_xla_vjp`` does.  Each
kernel wrapper also has its own plain version (:func:`_stage_a_reference`,
:func:`_stage_b_reference`) with the kernel's exact layout, so the
four-step split is checked on the CPU.
``cwt_stage_b``'s ablation variants (``tools/relayout_experiment.py``) have
theirs in :func:`_stage_b_ablation_reference`.

For nfft ≤ 2^12, ``small_kernel=True`` (or ``PYCWT_TPU_SMALL_KERNEL=1``)
selects the JAX package's opt-in small-nfft kernel ``_make_kernel_direct``
instead, ported as ``cwt_direct`` (``csrc/direct_cwt.cu``) for the same
function

    W[s, t] = (1/N) Σ_{k<K} X[k]·H̄_s[k] e^{2πi·kt/N},  K = N or (analytic) N/2

which the TPU ran as a direct DFT and the CUDA kernel runs as one on-chip
inverse FFT per row: filter, Stockham passes of the radices in
:func:`_direct_radix_plan`, 1/N and the epilogue, in one launch.  Its plain
version :func:`_direct_reference` keeps the TPU's formulation (a complex
matmul against the (K, N) DFT matrix) and runs for a CPU tensor on that
route; :func:`_direct_stockham_reference` mirrors the kernel's passes for
the tests.  Above 2^12 the option is ignored and the two kernels run, as in
the JAX package.
"""
from __future__ import annotations

import math
import os

import torch

from ..config import _PRECISIONS
from ..mothers import DOG, Morlet, Mother, Paul
from ..utils import profiling
from ..utils.profiling import span
from ._precision import full_f32_matmul
from .fft import _spectrum_f64
from .filterbank import angular_frequencies
from .mxu_dft import supported_n

__all__ = ["fused_cwt", "fused_cwt_planar", "supported_nfft",
           "KERNEL_LAUNCHES", "STAGE_B_WIDE_LAUNCHES", "STAGE_B_COMPLEX_LAUNCHES",
           "stage_a", "stage_b", "cwt_direct"]

#: Launches of each CUDA kernel, counted by its wrapper where it launches;
#: the ``_bf16`` entries are the stages with a bf16 T (``precision="fast"``).
KERNEL_LAUNCHES = {"cwt_stage_a": 0, "cwt_stage_b": 0, "cwt_direct": 0,
                   "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}
#: Launches of the f32 ``cwt_stage_b`` (of ``KERNEL_LAUNCHES["cwt_stage_b"]``)
#: that ran StageB's wide block: 1024 threads over 8 columns at R1 = 2048
STAGE_B_WIDE_LAUNCHES = 0
#: Launches of ``cwt_stage_b`` and ``cwt_stage_b_bf16`` in the complex
#: epilogue (``output="complex"``), which store complex64 W themselves
STAGE_B_COMPLEX_LAUNCHES = 0

#: T's element types: f32, and bf16 at the ``fast`` tier
_T_DTYPES = (torch.float32, torch.bfloat16)

#: Largest nfft that ``small_kernel`` routes to ``cwt_direct``
#: (``pycwt_tpu/ops/pallas_fft.py:73``).
_SMALL_KERNEL_MAX = 1 << 12
#: cwt_direct's block holds at least this many points: whole rows, 1024/nfft
#: of them below 1024 (kMinPoints in csrc/direct_cwt.cu)
_DIRECT_BLOCK_POINTS = 1024

#: epilogue -> the kernels' mode id (enum Mode in csrc/fft_common.cuh);
#: ``cwt_direct`` runs "complex" as "planes" and assembles them
_MODES = {"planes": 0, "power": 1, "power_sum": 2, "complex": 3}

#: Points a cwt_stage_a/cwt_stage_b block holds at most (cols·R ≤ 8192:
#: 512 threads of 16 points, ~70 KB; two blocks fit on one SM), and the most
#: shared memory a Hopper block may take (227 KB).
_BLOCK_POINTS = 8192
_SMEM_MAX = 232448
#: R1 where cwt_stage_b takes wide blocks, by T's element type: 1024
#: threads over 16384 points, 16 columns at R1 = 1024 and 8 at 2048
#: (StageB in csrc/fused_cwt.cu)
_WIDE_R1 = {torch.float32: (2048,), torch.bfloat16: (1024, 2048)}
_WIDE_POINTS = 16384


def supported_nfft(nfft: int) -> bool:
    """Pow-2 lengths ≥ 2^8.  Each runs the two kernels ``cwt_stage_a`` and
    ``cwt_stage_b``; with ``small_kernel`` those ≤ 2^12 run ``cwt_direct``."""
    return nfft >= (1 << 8) and (1 << (nfft.bit_length() - 1)) == nfft


def _nfft_factors(nfft: int) -> tuple[int, int]:
    """(R1, R2) with N = R2·R1 and R1 = 2^⌊log2 N / 2⌋."""
    p = nfft.bit_length() - 1
    R1 = 1 << (p // 2)
    return R1, nfft // R1


def _column_radix_plan(R: int) -> tuple[int, ...]:
    """Radices of the column FFT of ``cwt_stage_a``/``cwt_stage_b`` for R
    points, R a power of two in [16, 8192]: radix-16 passes and a last radix
    of 2, 4, 8 or 16, e.g. 16 at 16, 16·2 at 32, 16·16·4 at 1024, 16·16·16·2
    at 8192 (ColumnPlan in csrc/fft_common.cuh; the kernels refuse any
    other)."""
    if R < 16 or R > _BLOCK_POINTS or R & (R - 1):
        raise ValueError(f"column FFTs serve pow-2 lengths in [16, 8192], got {R}")
    q = (R.bit_length() - 2) // 4
    return (16,) * q + (R >> (4 * q),)


def _column_ld(R: int, cols: int) -> int:
    """Column stride of a block's buffer in complex slots (column_ld in
    csrc/fused_cwt.cu): R points padded one in 16, rounded up to
    16/min(cols, 16) mod 16 so that accesses across columns miss no bank."""
    padded = R + R // 16
    return padded + (16 // min(cols, 16) - padded) % 16


def _smem_bytes(R: int, cols: int) -> int:
    """Dynamic shared memory of one block (smem_bytes in csrc/fused_cwt.cu):
    the twiddle tables (none for one pass, 256 roots for two, 64 + R/64 more
    for three or four), then ``cols`` padded columns, 8 bytes a point."""
    passes = len(_column_radix_plan(R))
    tw = 0 if passes < 2 else 256 + (64 + R // 64 if passes > 2 else 0)
    return 8 * (tw + cols * _column_ld(R, cols))


def _tile_cols(R: int, n_cols: int) -> int:
    """Columns per block for R-point column FFTs, R/16 threads each: as many
    as fit in 8192 points (512 threads, at most ~73 KB of shared memory), at
    most the ``n_cols`` there are."""
    if R > _BLOCK_POINTS:
        raise ValueError(f"a {R}-point column does not fit one block "
                         f"({_BLOCK_POINTS} points at most)")
    return min(n_cols, _BLOCK_POINTS // R)


def _t_dtype(precision: str) -> torch.dtype:
    """T's element type at a precision tier: bf16 at ``fast``, else f32."""
    return torch.bfloat16 if precision == "fast" else torch.float32


def _stage_b_wide(R1: int, t_dtype) -> bool:
    """Whether ``cwt_stage_b`` runs a wide block of 1024 threads for T's
    element type at R1 (:data:`_WIDE_R1`)."""
    return R1 in _WIDE_R1.get(t_dtype, ())


def _stage_b_cols(R1: int, R2: int, t_dtype) -> int:
    """Columns of T one ``cwt_stage_b`` block runs: :func:`_tile_cols`, or
    in a wide block (:func:`_stage_b_wide`) twice that, so that T's rows
    and W's rows are 32 bytes or more: 8 at R1 = 2048 (f32 T, and a bf16 T,
    whose pair of blocks stages 16 columns), 16 for a bf16 T at 1024."""
    if _stage_b_wide(R1, t_dtype):
        return min(R2, _WIDE_POINTS // R1)
    return _tile_cols(R1, R2)


def _stage_b_smem_bytes(R1: int, cols: int, t_dtype) -> int:
    """Dynamic shared memory of one ``cwt_stage_b`` block: :func:`_smem_bytes`,
    and for the pair of a bf16 T at R1 = 2048 its staged half-tile after the
    buffer, 16-byte aligned: R1/2 rows of 16 bf16 columns, two planes
    (pair_half_slot and kPairHalfBytes in csrc/fused_cwt.cu)."""
    if not (t_dtype == torch.bfloat16 and R1 == 2048):
        return _smem_bytes(R1, cols)
    slot = _smem_bytes(R1, cols) // 8
    return 8 * (slot + slot % 2) + 2 * (R1 // 2) * 16 * 2


def _is_analytic(mother: Mother) -> bool:
    return bool(getattr(mother, "analytic_negligible_negative", lambda: False)())


def _mother_args(mother: Mother):
    """(id, f0, m) of the kernel's envelope switch."""
    if isinstance(mother, Morlet):
        return 0, float(mother.f0), 0
    if isinstance(mother, Paul):
        return 1, 0.0, int(mother.m)
    if isinstance(mother, DOG):
        return 2, 0.0, int(mother.m)
    raise TypeError(f"no CUDA envelope for mother {mother!r}")


def _check_device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"fused CWT runs on 'cpu' or 'cuda' tensors, got {t.device}")
    return t.device.type


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def _fused_cwt_planar_reference(sr, si, scales, *, mother: Mother, nfft: int,
                                dt: float, output: str = "planes"):
    """The (S, nfft) bank × X, then ``torch.fft.ifft``, in the dtype given;
    differentiable.  ``sr``/``si`` are ``(..., n_in)`` with n_in = nfft or
    (analytic mothers) nfft/2, whose missing upper half is zero."""
    n_in = sr.shape[-1]
    if n_in < nfft:
        sr = torch.nn.functional.pad(sr, (0, nfft - n_in))
        si = torch.nn.functional.pad(si, (0, nfft - n_in))
    ftf = angular_frequencies(nfft, dt, sr.dtype, sr.device)
    scales = scales.to(sr.dtype)
    norm = torch.sqrt(2 * math.pi * scales / dt)
    env = mother.psi_ft_envelope(scales[:, None] * ftf[None, :])
    cbar = complex(mother.psi_ft_const()).conjugate()
    br = (norm[:, None] * env) * cbar.real
    bi = (norm[:, None] * env) * cbar.imag
    xr = sr[..., None, :]
    xi = si[..., None, :]
    W = torch.fft.ifft(torch.complex(xr * br - xi * bi, xr * bi + xi * br),
                       dim=-1)
    return _epilogue(W.real, W.imag, output)


def _direct_filtered(sr, si, scales, *, mother: Mother, nfft: int, dt: float):
    """Kernel K3's filtered ``(..., S, K)`` product X[k]·H̄_s[k] of the first
    K bins (K = nfft/2 for analytic mothers, even of a full spectrum;
    negative bins folded when K = nfft), complex in the dtype given."""
    K = nfft // 2 if _is_analytic(mother) else nfft
    dev, rdt = sr.device, sr.dtype
    k = torch.arange(K, device=dev)
    kf = torch.where(k >= nfft // 2, k - nfft, k) if K == nfft else k
    omega = (2.0 * math.pi / (nfft * dt)) * kf.to(rdt)
    scales = scales.to(rdt)
    env = mother.psi_ft_envelope(scales[:, None] * omega[None, :])
    norm = torch.sqrt(2.0 * math.pi * scales / dt)[:, None]
    cbar = complex(mother.psi_ft_const()).conjugate()
    h = torch.complex(norm * env * cbar.real, norm * env * cbar.imag)
    x = torch.complex(sr[..., :K], si[..., :K])
    return x[..., None, :] * h


def _roots(idx, n: int, dtype):
    """e^{2πi·idx/n}, built in f64 and cast to the complex ``dtype``."""
    return torch.polar(torch.ones((), dtype=torch.float64, device=idx.device),
                       (2.0 * math.pi / n) * idx.to(torch.float64)).to(dtype)


def _direct_reference(sr, si, scales, *, mother: Mother, nfft: int,
                      dt: float, output: str = "planes"):
    """Kernel K3's function in PyTorch, in the TPU kernel's formulation and
    the dtype given: the filtered product of :func:`_direct_filtered`, then a
    complex ``torch.matmul`` with the (K, nfft) matrix E[k, t] = e^{2πi·kt/N},
    built in f64 and cast, over N, in full f32 whatever the process sets
    (:func:`full_f32_matmul`).  Differentiable."""
    y = _direct_filtered(sr, si, scales, mother=mother, nfft=nfft, dt=dt)
    k = torch.arange(y.shape[-1], device=sr.device)
    E = _roots((k[:, None] * torch.arange(nfft, device=sr.device)[None, :]) % nfft,
               nfft, y.dtype)
    with full_f32_matmul():
        W = torch.matmul(y, E) / nfft
    return _epilogue(W.real, W.imag, output)


def _direct_radix_plan(nfft: int) -> tuple[int, ...]:
    """Radices of ``cwt_direct``'s Stockham passes: 16·16 at 2^8, and a third
    pass of radix nfft/256 (2, 4, 8, 16) from 2^9 to 2^12."""
    if not supported_nfft(nfft) or nfft > _SMALL_KERNEL_MAX:
        raise ValueError(f"cwt_direct serves pow-2 nfft in [2^8, 2^12], got {nfft}")
    return (16, 16) if nfft == 256 else (16, 16, nfft // 256)


def _radix_dft(v, R: int):
    """The R-point inverse DFT (unscaled) of the last dim of ``v``, as a
    full-f32 product (:func:`full_f32_matmul`)."""
    r = torch.arange(R, device=v.device)
    with full_f32_matmul():
        return v @ _roots((r[:, None] * r[None, :]) % R, R, v.dtype)


def _stockham_pass(x, R: int, Ns: int, twiddle: bool = True):
    """One of ``cwt_direct``'s passes on complex rows ``x`` (..., N) whose
    points are combined in groups of Ns: butterfly j reads x[j + r·N/R],
    multiplies by e^{2πi·(j mod Ns)·r/(Ns·R)} (unless not ``twiddle``), takes
    the R-point inverse DFT and writes its output r to
    (j div Ns)·Ns·R + j mod Ns + r·Ns."""
    N = x.shape[-1]
    j = torch.arange(N // R, device=x.device)[:, None]
    r = torch.arange(R, device=x.device)[None, :]
    v = x[..., j + r * (N // R)]
    if twiddle:
        v = v * _roots((j % Ns) * r, Ns * R, x.dtype)
    out = torch.empty_like(x)
    out[..., (j // Ns) * Ns * R + j % Ns + r * Ns] = _radix_dft(v, R)
    return out


def _stockham(x, plan, twiddle: bool = True):
    """The Stockham passes of ``plan`` (radices, in order) over the last dim
    of ``x``: the unnormalised inverse DFT, in the kernels' pass order (with
    ``twiddle=False`` the passes without their twiddles, a wrong transform)."""
    Ns = 1
    for R in plan:
        x = _stockham_pass(x, R, Ns, twiddle)
        Ns *= R
    return x


def _direct_stockham_reference(sr, si, scales, *, mother: Mother, nfft: int,
                               dt: float, output: str = "planes"):
    """Kernel K3's passes in PyTorch, for the tests: the filtered product of
    :func:`_direct_filtered` with zeros above K, the Stockham passes of
    :func:`_direct_radix_plan` in the kernel's order, 1/N, the epilogue."""
    y = _direct_filtered(sr, si, scales, mother=mother, nfft=nfft, dt=dt)
    y = torch.cat([y, y.new_zeros(y.shape[:-1] + (nfft - y.shape[-1],))], dim=-1)
    W = _stockham(y, _direct_radix_plan(nfft)) / nfft
    return _epilogue(W.real, W.imag, output)


def _column_stockham(x, dim: int):
    """``cwt_stage_a``/``cwt_stage_b``'s column FFT in PyTorch, for the
    tests: the unnormalised inverse DFT of complex ``x`` along ``dim`` by the
    passes of :func:`_column_radix_plan`, in the kernels' order."""
    y = _stockham(x.movedim(dim, -1), _column_radix_plan(x.shape[dim]))
    return y.movedim(-1, dim)


#: cwt_stage_b_ablation's variants -> their id (enum Ablate in
#: csrc/fft_common.cuh); ``tools/relayout_experiment.py`` says what each is
ABLATIONS = {"full": 0, "notwiddle": 1, "noexchange": 2, "butterflies": 3,
             "memcopy": 4}


def _thread_map(R: int, device):
    """cwt_stage_b's map of a length-R column onto its R/16 threads, 16
    points each: ``(src, dst)``, both ``(R/16, 16)``.  Thread lt loads
    v[k] = x[src[lt, k]] = x[lt + k·R/16]; the last pass (radix RL) leaves
    output d = dst[lt, q·RL + r] = lt + q·R/16 + r·R/RL in v[q·RL + r]."""
    TC, RL = R // 16, _column_radix_plan(R)[-1]
    lt = torch.arange(TC, device=device)[:, None]
    k = torch.arange(16, device=device)[None, :]
    return lt + k * TC, lt + (k // RL) * TC + (k % RL) * (R // RL)


def _register_passes(x, twiddle: bool):
    """cwt_stage_b's column FFT without the shared-memory exchange (the
    ``noexchange`` ablation, and ``butterflies`` when not ``twiddle``) over
    the last dim of ``x``: each thread runs every pass of
    :func:`_column_radix_plan` on its own 16 points in the column map of
    :func:`_thread_map`: the twiddles e^{2πi·(jj mod Ns)·r/(Ns·R)} of
    jj = lt + q·R/16, then the radix-R DFT of each group q of R consecutive
    registers.  Wrong by design beyond one pass."""
    R = x.shape[-1]
    src, dst = _thread_map(R, x.device)
    v = x[..., src]                                   # (..., R/16, 16)
    lt = torch.arange(R // 16, device=x.device)[:, None, None]
    Ns = 1
    for Rp in _column_radix_plan(R):
        v = v.reshape(*v.shape[:-1], 16 // Rp, Rp)
        if twiddle and Ns > 1:
            q = torch.arange(16 // Rp, device=x.device)[None, :, None]
            r = torch.arange(Rp, device=x.device)[None, None, :]
            v = v * _roots(((lt + q * (R // 16)) % Ns) * r, Ns * Rp, x.dtype)
        v = _radix_dft(v, Rp).flatten(-2)
        Ns *= Rp
    out = torch.empty_like(x)
    out[..., dst] = v
    return out


def _ablated_column(x, dim: int, variant: str):
    """The column FFT of cwt_stage_b's ablation ``variant`` (see
    :data:`ABLATIONS`) along ``dim``, for the tests and the card's check:
    ``full`` the kernels' passes (:func:`_column_stockham`), ``notwiddle``
    those passes without twiddles, ``noexchange`` and ``butterflies``
    :func:`_register_passes` with and without twiddles, ``memcopy`` the
    permutation of :func:`_thread_map` alone."""
    x = x.movedim(dim, -1)
    plan = _column_radix_plan(x.shape[-1])
    if variant in ("full", "notwiddle"):
        y = _stockham(x, plan, twiddle=variant == "full")
    elif variant in ("noexchange", "butterflies"):
        y = _register_passes(x, twiddle=variant == "noexchange")
    elif variant == "memcopy":
        src, dst = _thread_map(x.shape[-1], x.device)
        y = torch.empty_like(x)
        y[..., dst] = x[..., src]
    else:
        raise ValueError(f"variant must be one of {tuple(ABLATIONS)}, got {variant!r}")
    return y.movedim(-1, dim)


def _stage_b_ablation_reference(tr, ti, *, nfft: int, variant: str):
    """``cwt_stage_b_ablation``'s function in PyTorch: :func:`_stage_b_reference`'s
    planes on the column FFT of :func:`_ablated_column`."""
    return _stage_b_reference(
        tr, ti, nfft=nfft, output="planes",
        column_fft=lambda x, dim: _ablated_column(x, dim, variant))


def _column_ifft(x, dim: int):
    """The unnormalised inverse DFT of complex ``x`` along ``dim``
    (``torch.fft``): the stage references' column FFT."""
    return torch.fft.ifft(x, dim=dim, norm="forward")


def _epilogue(wr, wi, output: str):
    if output == "planes":
        return wr, wi
    if output == "complex":
        return torch.complex(wr, wi)
    power = wr * wr + wi * wi
    return power if output == "power" else power.sum(dim=-1)


def _stage_a_reference(sr, si, scales, *, mother: Mother, nfft: int,
                       dt: float, column_fft=_column_ifft, t_dtype=None):
    """Stage A in PyTorch with the kernel's layout: ``sr``/``si`` are
    ``(B, n_in)``; returns planar T of shape ``(B·S, R1, R2)``.  Analytic
    mothers read only rows b < R2/2 (k < N/2), as the kernel does.
    ``column_fft(y, dim)`` is the length-R2 inverse DFT (the tests pass the
    kernel's mirror :func:`_column_stockham`).  T comes in the dtype of the
    inputs, rounded once (to nearest even) to ``t_dtype`` where that is
    given, as ``cwt_stage_a_bf16`` rounds its f32 T."""
    R1, R2 = _nfft_factors(nfft)
    B, n_in = sr.shape
    rows = R2 // 2 if _is_analytic(mother) else R2
    x = torch.complex(sr, si).reshape(B, n_in // R1, R1)[:, :rows]
    dev, rdt = sr.device, sr.dtype
    k = (torch.arange(rows, device=dev)[:, None] * R1
         + torch.arange(R1, device=dev)[None, :])
    k = torch.where(k >= nfft // 2, k - nfft, k).to(rdt)
    omega = (2.0 * math.pi / (nfft * dt)) * k
    scales = scales.to(rdt)
    env = mother.psi_ft_envelope(scales[:, None, None] * omega[None])
    norm = torch.sqrt(2.0 * math.pi * scales / dt)[:, None, None]
    cbar = complex(mother.psi_ft_const()).conjugate()
    h = torch.complex(norm * env * cbar.real, norm * env * cbar.imag)
    y = x[:, None] * h[None]
    Z = column_fft(torch.cat([y, y.new_zeros(y.shape[:-2] + (R2 - rows, R1))], dim=-2),
                   -2)
    ac = (torch.arange(R2, dtype=torch.float64, device=dev)[:, None]
          * torch.arange(R1, dtype=torch.float64, device=dev)[None, :])
    tw = torch.polar(torch.ones_like(ac), (2 * math.pi / nfft) * ac)
    T = (Z * tw.to(Z.dtype)).transpose(-1, -2).reshape(-1, R1, R2)
    if t_dtype is None:
        return T.real.contiguous(), T.imag.contiguous()
    return T.real.to(t_dtype).contiguous(), T.imag.to(t_dtype).contiguous()


def _stage_b_reference(tr, ti, *, nfft: int, output: str, column_fft=_column_ifft):
    """Stage B in PyTorch: T ``(rows, R1, R2)`` → W planes ``(rows, N)`` ×2,
    complex W ``(rows, N)``, |W|² ``(rows, N)``, or Σ_t |W|² ``(rows,)``
    (:func:`_epilogue`); ``column_fft`` as in
    :func:`_stage_a_reference`, of length R1.  A bf16 T is widened to f32
    first (exactly), as ``cwt_stage_b_bf16`` does."""
    if tr.dtype == torch.bfloat16:
        tr, ti = tr.to(torch.float32), ti.to(torch.float32)
    M = column_fft(torch.complex(tr, ti), -2) / nfft
    W = M.reshape(tr.shape[0], nfft)
    return _epilogue(W.real, W.imag, output)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check_grid(blocks: int) -> None:
    if blocks >= 1 << 31:
        raise ValueError(f"{blocks} blocks exceed a CUDA grid; split the batch")


def _plan_args(R: int) -> tuple[int, ...]:
    """:func:`_column_radix_plan` padded with 1s to the kernels' four
    plan arguments."""
    plan = _column_radix_plan(R)
    return plan + (1,) * (4 - len(plan))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def _count_t(points: int, bf16: bool) -> None:
    if bf16:
        profiling.T_BF16_POINTS += points
    else:
        profiling.T_F32_POINTS += points


def stage_a(sr, si, scales, *, mother: Mother, nfft: int, dt: float,
            t_dtype=torch.float32):
    """Kernel A: ``(B, n_in)`` planar spectra and ``(S,)`` scales → planar T
    ``(B·S, R1, R2)`` of ``t_dtype``: f32 (``cwt_stage_a``) or bf16 rounded
    to nearest even (``cwt_stage_a_bf16``); any other type raises
    ``ValueError``.  CPU tensors run :func:`_stage_a_reference` (an f32 T
    there keeps the inputs' dtype).  T's points are counted in
    ``profiling.T_BF16_POINTS`` or ``T_F32_POINTS``."""
    if t_dtype not in _T_DTYPES:
        raise ValueError(f"T must be float32 or bfloat16, got {t_dtype}")
    bf16 = t_dtype == torch.bfloat16
    if _check_device(sr) == "cpu":
        T = _stage_a_reference(sr, si, scales, mother=mother, nfft=nfft,
                               dt=dt, t_dtype=t_dtype if bf16 else None)
        _count_t(T[0].numel(), bf16)
        return T
    from ._build import library

    R1, R2 = _nfft_factors(nfft)
    B, n_in = sr.shape
    if n_in not in (nfft, nfft // 2) or si.shape != sr.shape or scales.ndim != 1:
        raise ValueError(f"spectra {tuple(sr.shape)}/{tuple(si.shape)} and scales "
                         f"{tuple(scales.shape)} do not fit nfft={nfft}")
    sr = sr.to(torch.float32).contiguous()
    si = si.to(device=sr.device, dtype=torch.float32).contiguous()
    scales = scales.to(device=sr.device, dtype=torch.float32).contiguous()
    S = scales.shape[0]
    cols = _tile_cols(R2, R1)
    _check_grid(B * S * (R1 // cols))
    rows = R2 // 2 if _is_analytic(mother) else R2
    kind, f0, m = _mother_args(mother)
    cbar = complex(mother.psi_ft_const()).conjugate()
    tr = torch.empty((B * S, R1, R2), dtype=t_dtype, device=sr.device)
    ti = torch.empty_like(tr)
    name = "cwt_stage_a_bf16" if bf16 else "cwt_stage_a"
    with torch.cuda.device(sr.device):
        err = getattr(library("fused_cwt"), name)(
            sr.data_ptr(), si.data_ptr(), n_in, scales.data_ptr(),
            tr.data_ptr(), ti.data_ptr(),
            B, S, R1, R2, rows, cols, kind, f0, m, cbar.real, cbar.imag,
            float(dt), 2.0 * math.pi / (nfft * dt), *_plan_args(R2),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    KERNEL_LAUNCHES[name] += 1
    _count_t(tr.numel(), bf16)
    return tr, ti


def stage_b(tr, ti, *, nfft: int, output: str):
    """Kernel B: planar T ``(rows, R1, R2)``, f32 (``cwt_stage_b``) or bf16
    (``cwt_stage_b_bf16``, widened exactly to f32), → W planes, complex64 W
    (stored by the kernel, interleaved), |W|² or Σ_t |W|² (see
    :func:`_stage_b_reference`); a T of any other type raises
    ``ValueError``.  CPU tensors run the plain version, which also takes the
    f64 T that :func:`stage_a` gives for f64 inputs there."""
    global STAGE_B_WIDE_LAUNCHES, STAGE_B_COMPLEX_LAUNCHES
    cpu = _check_device(tr) == "cpu"
    if tr.dtype != ti.dtype or not (
            tr.dtype in _T_DTYPES or (cpu and tr.dtype == torch.float64)):
        raise ValueError(f"T must be two float32 or bfloat16 planes, got "
                         f"{tr.dtype} and {ti.dtype}")
    if cpu:
        return _stage_b_reference(tr, ti, nfft=nfft, output=output)
    from ._build import library

    R1, R2 = _nfft_factors(nfft)
    rows = tr.shape[0]
    if (tuple(tr.shape) != (rows, R1, R2) or ti.shape != tr.shape
            or ti.device != tr.device):
        raise ValueError(f"T must be two ({rows}, {R1}, {R2}) planes on one "
                         f"device, got {tuple(tr.shape)} and {tuple(ti.shape)}")
    bf16 = tr.dtype == torch.bfloat16
    tr = tr.contiguous()
    ti = ti.contiguous()
    cols = _stage_b_cols(R1, R2, tr.dtype)
    _check_grid(rows * (R2 // cols))
    kw = dict(dtype=torch.float32, device=tr.device)
    if output == "planes":
        out0, out1 = torch.empty((rows, nfft), **kw), torch.empty((rows, nfft), **kw)
    elif output == "complex":
        # interleaved (re, im) floats: the kernel stores one float2 a point
        out0, out1 = torch.empty((rows, nfft), dtype=torch.complex64, device=tr.device), None
    elif output == "power":
        out0, out1 = torch.empty((rows, nfft), **kw), None
    else:
        out0, out1 = torch.empty((rows, R2 // cols), **kw), torch.empty((rows,), **kw)
    name = "cwt_stage_b_bf16" if bf16 else "cwt_stage_b"
    with torch.cuda.device(tr.device):
        err = getattr(library("fused_cwt"), name)(
            tr.data_ptr(), ti.data_ptr(), out0.data_ptr(),
            None if out1 is None else out1.data_ptr(),
            rows, R1, R2, cols, _MODES[output], 1.0 / nfft, *_plan_args(R1),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, name)
    KERNEL_LAUNCHES[name] += 1
    if not bf16 and _stage_b_wide(R1, tr.dtype):
        STAGE_B_WIDE_LAUNCHES += 1
    if output == "complex":
        STAGE_B_COMPLEX_LAUNCHES += 1
    if output == "planes":
        return out0, out1
    return out1 if output == "power_sum" else out0


def cwt_direct(sr, si, scales, *, mother: Mother, nfft: int, dt: float,
               output: str = "planes"):
    """Kernel K3: ``(B, n_in)`` planar spectra and ``(S,)`` scales → W planes
    ``(B, S, nfft)`` ×2, |W|² ``(B, S, nfft)`` or Σ_t |W|² ``(B, S)``, f32,
    for pow-2 nfft in [2^8, 2^12]: one launch, an on-chip inverse FFT per
    row with the epilogue inside.  ``"complex"`` is the planes, assembled
    into complex64 W after the launch.  CPU tensors run
    :func:`_direct_reference`."""
    if _check_device(sr) == "cpu":
        return _direct_reference(sr, si, scales, mother=mother, nfft=nfft, dt=dt,
                                 output=output)
    if output == "complex":
        return torch.complex(*cwt_direct(sr, si, scales, mother=mother, nfft=nfft,
                                         dt=dt, output="planes"))
    from ._build import library

    B, n_in = sr.shape
    K = nfft // 2 if _is_analytic(mother) else nfft
    if (not supported_nfft(nfft) or nfft > _SMALL_KERNEL_MAX
            or n_in not in (nfft, nfft // 2) or n_in < K
            or si.shape != sr.shape or scales.ndim != 1 or output not in _MODES):
        raise ValueError(f"spectra {tuple(sr.shape)}/{tuple(si.shape)}, scales "
                         f"{tuple(scales.shape)} and output {output!r} do not fit "
                         f"cwt_direct at nfft={nfft} (2^8..2^12; K={K} bins)")
    plan = _direct_radix_plan(nfft)
    sr = sr.to(torch.float32).contiguous()
    si = si.to(device=sr.device, dtype=torch.float32).contiguous()
    scales = scales.to(device=sr.device, dtype=torch.float32).contiguous()
    S = scales.shape[0]
    _check_grid(-(-B * S // max(1, _DIRECT_BLOCK_POINTS // nfft)))
    kind, f0, m = _mother_args(mother)
    cbar = complex(mother.psi_ft_const()).conjugate()
    shape = (B, S) if output == "power_sum" else (B, S, nfft)
    out0 = torch.empty(shape, dtype=torch.float32, device=sr.device)
    out1 = torch.empty_like(out0) if output == "planes" else None
    with torch.cuda.device(sr.device):
        err = library("direct_cwt").cwt_direct(
            sr.data_ptr(), si.data_ptr(), n_in, scales.data_ptr(),
            out0.data_ptr(), None if out1 is None else out1.data_ptr(),
            B, S, nfft, K, kind, f0, m, cbar.real, cbar.imag, float(dt),
            2.0 * math.pi / (nfft * dt), _MODES[output], *plan, *(1,) * (3 - len(plan)),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "cwt_direct")
    KERNEL_LAUNCHES["cwt_direct"] += 1
    return (out0, out1) if output == "planes" else out0


class _FusedCWT(torch.autograd.Function):
    """Forward: the two CUDA kernels, with a bf16 T at ``precision="fast"``
    and an f32 one at the other tiers (on CPU tensors their plain versions).
    Backward: the gradient of the f32 plain version on the saved inputs at
    every tier (there is no backward kernel), as ``_with_xla_vjp`` replays
    the f32 reference."""

    @staticmethod
    def forward(ctx, sr, si, scales, mother, nfft, dt, output, precision="highest"):
        ctx.save_for_backward(sr, si, scales)
        ctx.params = (mother, nfft, dt, output)
        T = stage_a(sr, si, scales, mother=mother, nfft=nfft, dt=dt,
                    t_dtype=_t_dtype(precision))
        out = stage_b(*T, nfft=nfft, output=output)
        # the plain version's shapes: (B, S, nfft) or (B, S)
        shape = (sr.shape[0], scales.shape[0]) + ((nfft,) if output != "power_sum" else ())
        if output == "planes":
            return tuple(o.reshape(shape) for o in out)
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, *grads):
        mother, nfft, dt, output = ctx.params
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = _fused_cwt_planar_reference(*inputs, mother=mother,
                                              nfft=nfft, dt=dt, output=output)
            outs = out if isinstance(out, tuple) else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs],
                                      wanted, [g for _, g in pairs],
                                      allow_unused=True) if wanted else ()
        got = iter(got)
        result = [next(got) if t.requires_grad else None for t in inputs]
        return (*result, None, None, None, None, None)


class _FusedDirect(_FusedCWT):
    """Forward: kernel K3 (``cwt_direct``) with the epilogue inside the
    kernel (the JAX package runs it after its kernel; the results agree
    within the tier bounds).  It holds no intermediate in memory, so every
    ``precision`` runs the same kernel, as ``pycwt_tpu``'s small kernel.
    Backward: inherited, the gradient of the plain version."""

    @staticmethod
    def forward(ctx, sr, si, scales, mother, nfft, dt, output, precision="highest"):
        ctx.save_for_backward(sr, si, scales)
        ctx.params = (mother, nfft, dt, output)
        return cwt_direct(sr, si, scales, mother=mother, nfft=nfft, dt=dt,
                          output=output)


@span("fused_cwt")
def fused_cwt_planar(sig_r, sig_i, scales, *, mother: Mother, nfft: int,
                     dt: float, Ablk: int = 256, Cblk: int = 256,
                     power_only: bool = False, interpret: bool = False,
                     precision: str = "highest",
                     small_kernel: bool | None = None,
                     output: str | None = None):
    """Planar fused CWT of one spectrum ``(n_in,)`` or a batch ``(B, n_in)``.

    ``n_in`` is ``nfft`` (full spectrum) or, for analytic mothers, ``nfft/2``
    (``fft_of_real_planar(half=True)``).  ``output`` selects the epilogue:
    ``"planes"`` (default) returns ``(wr, wi)`` each ``(..., S, nfft)``;
    ``"complex"`` returns complex64 W ``(..., S, nfft)``, stored by
    ``cwt_stage_b`` itself (``cwt_direct`` assembles its planes);
    ``"power"`` returns |W|² ``(..., S, nfft)``; ``"power_sum"`` returns
    Σ_t |W|² ``(..., S)`` (the legacy ``power_only=True``).  ``Ablk``,
    ``Cblk`` (the Pallas kernels' block sizes) and ``interpret`` (Pallas's
    interpret mode) are accepted for calls written against ``pycwt_tpu`` and
    ignored: the CUDA kernels size their own blocks, and a CPU tensor runs
    the plain version.

    ``precision`` selects T, the intermediate between the two kernels, at
    every nfft they serve: ``"highest"`` and ``"high"`` run
    ``cwt_stage_a``/``cwt_stage_b`` on an f32 T (on a CPU tensor
    :func:`_fused_cwt_planar_reference`); ``"fast"`` runs
    ``cwt_stage_a_bf16``/``cwt_stage_b_bf16``, whose T is bf16, rounded to
    nearest even and widened back to f32 (on a CPU tensor the two stages'
    plain versions with a bf16 T), as ``pycwt_tpu``'s fast tier stores T
    (within its 2e-2 of max|W|).  The gradient is the f32 plain version's
    at every tier.

    ``small_kernel=True`` (or, when it is None, ``PYCWT_TPU_SMALL_KERNEL=1``)
    runs the one-launch kernel ``cwt_direct`` for nfft ≤ 2^12 and is ignored
    above, as in the JAX package; on a CPU tensor its plain version runs.
    ``cwt_direct`` holds no T, so every tier runs it alike.
    """
    if small_kernel is None:
        small_kernel = os.environ.get("PYCWT_TPU_SMALL_KERNEL") == "1"
    if output is None:
        output = "power_sum" if power_only else "planes"
    elif power_only and output != "power_sum":
        raise ValueError(
            f"conflicting epilogue selection: power_only=True means "
            f"output='power_sum' but output={output!r} was passed — drop "
            f"power_only (deprecated) and pass output= alone")
    if output not in _MODES:
        raise ValueError(f"output must be planes|complex|power|power_sum, got {output!r}")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    if not supported_nfft(nfft):
        raise ValueError(f"fused kernel needs pow-2 nfft >= 256, got {nfft}")
    analytic = _is_analytic(mother)
    n_in = sig_r.shape[-1]
    if n_in == nfft // 2 and not analytic:
        raise ValueError(
            "half-spectrum input requires an analytic mother "
            f"({mother.name} reads negative-frequency bins)")
    if n_in != nfft and n_in != nfft // 2:
        raise ValueError(
            f"spectrum length {n_in} incompatible with nfft={nfft} "
            f"(half-spectrum input needs an analytic mother)")
    scales = torch.as_tensor(scales, device=sig_r.device)
    small = bool(small_kernel) and nfft <= _SMALL_KERNEL_MAX

    # a CPU tensor runs the plain version; at `fast` that is the two stages'
    # plain versions with a bf16 T, through _FusedCWT as on the card
    if _check_device(sig_r) == "cpu" and (small or precision != "fast"):
        plain = _direct_reference if small else _fused_cwt_planar_reference
        return plain(sig_r, sig_i, scales, mother=mother, nfft=nfft,
                     dt=float(dt), output=output)
    lead = sig_r.shape[:-1]
    route = _FusedDirect if small else _FusedCWT
    out = route.apply(sig_r.reshape(-1, n_in), sig_i.reshape(-1, n_in),
                      scales, mother, nfft, float(dt), output, precision)
    if output == "planes":
        return tuple(o.reshape(*lead, *o.shape[1:]) for o in out)
    return out.reshape(*lead, *out.shape[1:])


def _planar_cwt_of_real(y, scales, *, mother: Mother, nfft: int, dt: float,
                        precision: str = "highest", output: str = "planes"):
    """The planar route's one entry, from real rows to the kernels: the
    forward CWT of rows ``y`` ``(..., n)`` on f32 planes, the spectrum
    zero-padded to ``nfft``, taken in f64 from the rows as given and rounded
    once to f32 planes (``ops/fft._spectrum_f64``), then
    :func:`fused_cwt_planar` (the kernels on a CUDA tensor), or its plain
    version below the kernels' 2^8.  Returns the untrimmed width-``nfft``
    ``output`` (``"planes"``: ``(wr, wi)``, each ``(..., S, nfft)``).  A
    non-pow-2 ``nfft`` raises: the planar route has no other."""
    if not supported_n(nfft):
        raise ValueError(
            f"the planar route needs a power-of-two nfft, got {nfft}. Use "
            "CWTConfig(pad_pow2=True) or a complex engine ('xla'/'mxu').")
    spec = _spectrum_f64(torch.as_tensor(y), nfft)
    sr, si = spec.real.contiguous(), spec.imag.contiguous()
    scales = torch.as_tensor(scales).to(device=sr.device, dtype=torch.float32)
    if supported_nfft(nfft):
        return fused_cwt_planar(sr, si, scales, mother=mother, nfft=nfft,
                                dt=float(dt), precision=precision, output=output)
    return _fused_cwt_planar_reference(sr, si, scales, mother=mother, nfft=nfft,
                                       dt=float(dt), output=output)


def fused_cwt(signal_ft, scales, *, mother: Mother, nfft: int, dt: float,
              Ablk: int = 256, Cblk: int = 256, power_only: bool = False,
              interpret: bool = False, precision: str = "highest",
              small_kernel: bool | None = None):
    """Complex-input convenience wrapper over :func:`fused_cwt_planar`:
    returns complex W ``(..., S, nfft)`` (un-trimmed; the ``"complex"``
    epilogue), or Σ_t |W|² when ``power_only``.  ``Ablk``, ``Cblk`` and
    ``interpret`` are accepted and ignored, as there."""
    return fused_cwt_planar(signal_ft.real.to(torch.float32),
                            signal_ft.imag.to(torch.float32), scales,
                            mother=mother, nfft=nfft, dt=dt,
                            output="power_sum" if power_only else "complex",
                            precision=precision, small_kernel=small_kernel)
