"""The example workflows, ported from ``examples/*.py`` of ``pycwt_tpu``.

Each module runs as a script and exposes ``run(...)``, which returns the
arrays the script prints and plots, beside ``main(...)``, which prints and
draws::

    python -m pycwt_torch.examples.sample_cwt [nino3|mauna|monsoon|sunspots|soi|--all]
                                              [--outdir DIR] [--device DEV]
    python -m pycwt_torch.examples.sample_xwt [--outdir DIR] [--device DEV]
    python -m pycwt_torch.examples.sample_network [--device DEV]

``--device`` defaults to ``cuda``: without a card the scripts stop and name
``--device cpu``.  The JAX scripts' environment variables keep their names
(``PYCWT_TPU_MC_COUNT``, ``PYCWT_TPU_NETWORK_B``, and the engine and kernel
switches the library reads).
"""
from __future__ import annotations

import argparse
import tempfile

import torch


def parser(description: str, outdir: bool = True) -> argparse.ArgumentParser:
    """The options every example takes: ``--device`` and, where it draws,
    ``--outdir`` (default: the system's temporary directory)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device of the analysis (default: cuda)")
    if outdir:
        p.add_argument("--outdir", default=tempfile.gettempdir(),
                       help="directory of the figures")
    return p


def device_of(p: argparse.ArgumentParser, args: argparse.Namespace) -> torch.device:
    """``--device`` through the port's device rule; without a card the
    script stops with the rule's message and the option to pass."""
    from ..api import _resolve_device

    try:
        return _resolve_device(args.device)
    except RuntimeError as err:
        p.error(f"{err} (on the command line: --device cpu)")


def pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
