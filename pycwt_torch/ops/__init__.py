"""Compute ops: filter banks, FFT engines, spectra, the fused CUDA CWT."""

from .filterbank import apply_filter_bank, filter_bank  # noqa: F401
