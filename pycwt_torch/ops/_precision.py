"""Full-f32 matrix products whatever the process sets.

``pycwt_tpu`` pins ``jax.lax.Precision.HIGHEST`` on its smoothing products
(``pycwt_tpu/ops/smoothing.py``), so no caller's setting reaches them.  In
PyTorch an f32 product follows process-wide flags instead:
``torch.set_float32_matmul_precision("high")`` or
``torch.backends.cuda.matmul.allow_tf32 = True`` run it in TF32 on the card,
``"medium"`` in bf16 there and, through oneDNN, on the CPU too.
:func:`full_f32_matmul` is the port's ``HIGHEST``: for its scope it sets the
per-operation setting of both backends' matrix products
(``torch.backends.cuda.matmul.fp32_precision`` and
``torch.backends.mkldnn.matmul.fp32_precision``) to ``"ieee"``, and on exit
writes back the values it found.  The older setters
(``set_float32_matmul_precision``, ``allow_tf32``) and the newer ones
(``torch.backends.fp32_precision`` and the per-backend settings) all write
these two values, so whichever API the caller used reads back unchanged.

The settings are process-wide: a product that another thread runs inside
the scope runs in full f32 as well.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32_matmul"]


@contextlib.contextmanager
def full_f32_matmul():
    """Run the f32 matrix products of the ``with`` block in full f32 (IEEE,
    no TF32, no bf16) and restore the caller's settings on exit, also when
    the block raises.  Raises where this PyTorch has no per-operation
    setting, rather than run the products under the caller's."""
    try:
        cuda, onednn = torch.backends.cuda.matmul, torch.backends.mkldnn.matmul
        saved = (cuda.fp32_precision, onednn.fp32_precision)
    except AttributeError as err:
        raise RuntimeError(
            "pycwt_torch pins its f32 matrix products to full f32 through "
            "torch.backends.{cuda,mkldnn}.matmul.fp32_precision, which this "
            f"PyTorch ({torch.__version__}) lacks; it needs PyTorch >= 2.9"
        ) from err
    try:
        cuda.fp32_precision = "ieee"
        onednn.fp32_precision = "ieee"
        yield
    finally:
        cuda.fp32_precision, onednn.fp32_precision = saved
