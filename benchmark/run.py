"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device
(with --trace 1 also busy_s and window_s of the profiler's stretch),
breakdown (--trace 1), and last the checks: each number compared with
its limit, which also close standard error. Exits non-zero, with no
result, where torch sees no CUDA device or fewer than the cell asks for,
where the process holds JAX or the JAX package once the run is over
(the window, the stage graphs, the reference's frames and every
per-layer reader), or on any error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell, spec

    bench = spec.benchmark()
    workload = spec.workload(bench, args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < workload["chips"]):
        print(f"workload {args.workload} needs {workload['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, info = cell.run(bench, workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0),
                            T_START)
    return report(result, info)


def report(result: dict, info: dict) -> int:
    """Print the run's record and its result line, then its checks; or,
    where the process holds JAX or the JAX package now that everything
    that runs has run, name what it holds and print no result."""
    from benchmark.harness import cell

    found = cell.forbidden_modules()
    if found:
        print("the process holds JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(info), file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 - report, print no result, fail
        traceback.print_exc()
        sys.exit(1)
