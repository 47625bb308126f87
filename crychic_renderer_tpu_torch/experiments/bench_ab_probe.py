"""A/B of the port's bench entry points of other checkouts and this one on
one card, in turns.

    python -m crychic_renderer_tpu_torch.experiments.bench_ab_probe \
        --other build/a [build/b ...]

``--other`` names other checkouts of the repository (for example ``git
archive``s of older commits unpacked under ``build/``). A checkout from
before the bench came in gets this checkout's ``bench.py`` and
``experiments/bench_all.py`` copied into its package: they use only the
Renderer's API, which the older checkouts share, so each turn times that
checkout's own frame. The turns run the others, this checkout twice,
then the others in reverse (a, b, this, this, b, a). Each turn runs
``python -m crychic_renderer_tpu_torch.bench`` and then ``python -m
crychic_renderer_tpu_torch.experiments.bench_all``, each a fresh process
at the checkout's root (its own package and kernels), and prints their
lines. Ends with one JSON line: the card (nvidia-smi name, power limit)
and, by checkout in turn order, the bench's value and rounds and each
bench_all config's ms/frame. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

from .. import bench

BENCH_FILES = ("bench.py", os.path.join("experiments", "bench_all.py"))


def _run(root: str, module: str, timeout: int) -> list:
    proc = subprocess.run([sys.executable, "-m", module],
                          cwd=os.path.abspath(root), capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} at {root} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout.strip().splitlines()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, nargs="+",
                    help="roots of the other checkouts")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_ab_probe: needs a CUDA device")
    card = bench.card(torch.device("cuda"))
    print(card, flush=True)
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    this = os.path.dirname(package)
    for root in args.other:
        for f in BENCH_FILES:
            dst = os.path.join(root, "crychic_renderer_tpu_torch", f)
            if not os.path.exists(dst):
                shutil.copyfile(os.path.join(package, f), dst)
    order = list(args.other) + ["this", "this"] + list(args.other)[::-1]
    result = {root: [] for root in order}
    for root in order:
        at = this if root == "this" else root
        line = json.loads(
            _run(at, "crychic_renderer_tpu_torch.bench", 600)[-1])
        print(f"{root} bench: {json.dumps(line)}", flush=True)
        lines = _run(at, "crychic_renderer_tpu_torch.experiments.bench_all",
                     900)
        for x in lines[1:]:
            print(f"{root} bench_all: {x}", flush=True)
        result[root].append(dict(
            value=line["value"], rounds_ms=line["rounds_ms"],
            bench_all={f"{r['config']}{' fast' if r['fast'] else ''}":
                       r["ms_per_frame"] for r in map(json.loads, lines[1:])}))
    print(json.dumps({"card": card, "other": args.other, "turns": result}))


if __name__ == "__main__":
    main()
