"""Experiments on the port's kernels, counterparts of ``tools/tpu_*.py``.

``python -m pycwt_torch.tools.relayout_experiment`` times ``cwt_stage_b``'s
ablation variants on the card (``relayout_experiment.py``).
"""
