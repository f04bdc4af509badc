"""The benchmark of pycwt_torch on one NVIDIA H100: ``run.py`` is its command,
``harness.py`` its engine."""
