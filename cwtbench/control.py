"""Readings that the limits of ``correct`` are set from, and the control.

    python3 cwtbench/control.py --workload <cell> --seeds 1,2,3 [--control] [--seconds 2]

For each seed it makes the cell's inputs, warms up, runs a short window of
the cell's own calls, and prints one JSON line with every number that a
run compares.  With ``--control`` the cell's control takes the program's
place, as its file says: ``{"precision": <tier>}`` runs the program at that
lower tier, ``{"reference": "tf32"}`` puts the reference computed in TF32 in
place of the program's outputs for the same calls.  All seeds run in one
process, so the CUDA library is built or loaded once.  The benchmark's own
runs do not run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, seconds: float, control: bool, device: str) -> dict:
    import torch

    from cwtbench import harness

    spec = cell.spec["control"] if control else {}
    entry = harness.make_entry(cell, seed, device, precision=spec.get("precision"))
    sync = harness.device_sync(device)
    entry.warm()
    window = harness.Window(setup_s=0.0)
    harness.measure(entry, seconds, sync, window)
    entry.release()
    numbers = entry.compare(control=spec.get("reference"))
    del entry
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return {"workload": cell.name, "seed": seed,
            "side": "control" if control else "program", "calls": window.calls,
            "failed": window.failed, **numbers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from cwtbench import harness

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("control: no CUDA device is available", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        row = readings(cell, seed, args.seconds, args.control, args.device)
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
