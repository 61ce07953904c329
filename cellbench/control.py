"""The control of a cell: the reference in the program's place with one
guarantee broken (the configuration's ``control`` entry), run through the
whole harness at the cell's own size.  Its readings are the upper ends of
the limits in ``PERF.md``; the benchmark's own runs never run it.

    python3 cellbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

One JSON line per seed; exits non-zero without a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from cellbench.harness import find_cell, load_benchmark, load_json, run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    _, centry = find_cell(load_benchmark(ROOT), args.workload)
    control = load_json(ROOT / centry["file"])["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(args.workload, seed, args.seconds, False, config_override={"system": control["system"]})
        line = {"control": args.workload, "seed": seed, "correct": r["correct"], "attempted": r["attempted"]}
        print(json.dumps({**line, "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
