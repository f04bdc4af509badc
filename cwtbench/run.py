"""The benchmark of ``pycwt_torch`` on one H100.

    python3 cwtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It exits non-zero, and prints no result,
without a CUDA card (or with fewer than the cell asks for), where the
program cannot be imported, or when a module of JAX or of the JAX package
is loaded once the window has closed.  Otherwise its last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``), and its
last lines of standard error are the numbers compared, each beside its
limit, which the line repeats under ``checks``, its last key.
"""
import os
import time

T_START = time.perf_counter()
# One process with one host thread: OpenMP and BLAS pools that spin beside
# a host-bound caller make its times swing from run to run.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from cwtbench import harness

    try:
        cell = harness.load_cell(args.workload, ROOT)
    except (harness.BenchError, KeyError) as err:
        print(f"cwtbench: {err}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("cwtbench: no CUDA device is available; the benchmark runs on "
              "the card only", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"cwtbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    try:
        import pycwt_torch  # noqa: F401
    except ImportError as err:
        print(f"cwtbench: the program pycwt_torch cannot be imported: {err}",
              file=sys.stderr)
        return 1

    result, checks = harness.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t_start=T_START, root=ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"cwtbench: the run loaded {', '.join(found)}; no module of JAX "
              "or of the JAX package may be loaded", file=sys.stderr)
        return 3
    # a comparison that could not be made reads inf: strict JSON has no inf
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stdout.flush()
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
