"""Run one cell of the benchmark once, from the root of a checkout:

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result as one JSON object;
the numbers compared with the reference, each beside its limit, are the
last lines of standard error.  Without a CUDA device (or fewer than the
cell asks for), or outside a checkout that holds the program, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a run may write sits at a fixed path inside the checkout
CACHE = ROOT / ".cellbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir() or not (ROOT / "BENCHMARK.json").is_file():
        print("cellbench: run from a checkout that holds BENCHMARK.json and src/repro_torch", file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from cellbench.harness import find_cell, forbidden_modules, load_benchmark, run_cell

    cell, _ = find_cell(load_benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(
            f"cellbench: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"cellbench: the run loaded {found}; the benchmark may load none of them", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
