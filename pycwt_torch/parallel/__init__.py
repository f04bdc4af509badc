"""Multi-device surfaces on ``torch.distributed`` ranks over a DeviceMesh.

Counterpart of ``pycwt_tpu/parallel``: one process per device,
:func:`make_mesh` over the dims ``("data", "scale", "mc")``, and outputs as
``DTensor``s (``.to_local()`` is the rank's block, ``.full_tensor()`` the
global array).  Start the ranks with ``torchrun`` (NCCL on the cards) or
call :func:`pycwt_torch.parallel.distributed.initialize` on each.
"""
from .mesh import make_mesh, MeshSpec  # noqa: F401
from .sharded import (  # noqa: F401
    sharded_cwt,
    sharded_power_pipeline,
    sharded_wct,
    sharded_wct_matrix,
    sharded_wct_pairs,
    sharded_mc_histogram,
    sharded_mc_histogram_pairs,
)
from .dist_fft import (sharded_cwt_spectral, sharded_cwt_spectral_planar,  # noqa: F401
                       sharded_dft, sharded_dft_planar, sharded_idft)  # noqa: F401
