"""Share of a ``cwt_power`` cell's host fetches through page-locked memory
that found a block in torch's cache: 100 × (1 − grows / fetches), over the
program's counter ``profiling.HOST_PINNED_FETCHES`` (``api._host``'s fetches
into pinned memory) and the blocks torch's caching host allocator created
meanwhile (its ``allocations.allocated``).

Both count every call of the window, those inside the profiled slice too.
The harness loads the per-layer metrics after the warm-up and before the
window, and again to read them.  The first load switches the span recorder
on, which sets the counter to 0, and sets the allocator's accumulated stats
back to 0 where CUDA runs, so the warm-up's growth is left out; a load
that finds pinned fetches counted leaves both alone.  A program without
the counter, or a window with no pinned fetch, reads nothing."""
import torch

from pycwt_torch.utils import profiling

getattr(profiling, "enable_spans", lambda: None)()
_FIRST = not getattr(profiling, "HOST_PINNED_FETCHES", 0)
if _FIRST and torch.cuda.is_initialized():
    torch.cuda.memory.reset_accumulated_host_memory_stats()


def read(trace):
    fetches = getattr(profiling, "HOST_PINNED_FETCHES", 0)
    if not fetches:
        return None
    stats = torch.cuda.memory.host_memory_stats_as_nested_dict()
    grows = stats.get("allocations", {}).get("allocated", 0)
    return 100.0 * (1 - grows / fetches)
