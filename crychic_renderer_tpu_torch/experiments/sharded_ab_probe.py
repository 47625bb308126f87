"""A/B time of the band-sharded frame of other checkouts and this one on
one card: chip_smoke.py phase 10 (config 4 at 1920x1080 on 4 gloo ranks
that time-share the card), in turns.

    python -m crychic_renderer_tpu_torch.experiments.sharded_ab_probe \
        --other build/a [build/b ...] [--frames 10]

``--other`` names other checkouts of the repository (for example ``git
archive``s of older commits unpacked under ``build/``). The turns run
the others, this checkout twice, then the others in reverse (a, b, this,
this, b, a). Each turn runs in a fresh process from the checkout's root,
with that checkout's package and kernels: the Renderer at 1080p, band
capacities autosized for 4 ranks and checked, then
``launch.render_sharded`` on 4 gloo ranks with 3 warm-up and ``--frames``
timed frames (its default frame: the compiled band frame in a checkout
that has parallel/graphs.py, the eager one before). A turn's number is rank 0's median ms/frame, phase 10's
number (the host clock around each frame, ending in a synchronize; a
frame ends in a collective, so every rank waits for the slowest). The
turns' images are held to each other (at most 1e-3 of pixels above
0.02). Prints the card (nvidia-smi name, power limit), each turn and one
JSON line (the medians by checkout, in turn order). Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

N_RANKS = 4
WARMUP = 3

# One turn, run with the checkout's root as the working directory, so the
# checkout's own package is imported. It uses only entry points both
# checkouts have (the port's API since the band-sharded frame came in).
TURN = """
import json, statistics, sys
import numpy as np, torch
from crychic_renderer_tpu_torch.app.renderer import Renderer
from crychic_renderer_tpu_torch.models.scenes_baseline import CONFIGS
from crychic_renderer_tpu_torch.ops import pcf, raster
from crychic_renderer_tpu_torch.parallel import launch, sharded
n, warmup, frames, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
raster.LIBRARY.load()
pcf.LIBRARY.load()
scene, cfg, lights = CONFIGS[4]()
r = Renderer(scene, cfg, lights=lights, device=dev)
c = r.frame_constants(0.0)
band_cfg = sharded.autosize_band_capacities(r.device_scene, c, r.cfg, n)
sharded.check_band_capacity(r.device_scene, c, band_cfg, n)
ranks = launch.render_sharded([r.device_scene], [c], [(band_cfg, 0, (0,))],
                              n, "gloo", dev, warmup=warmup, timed=frames,
                              timeout=600)
for (o,) in ranks:
    assert not o["overflowed"]
np.save(out, ranks[0][0]["img"])
print(json.dumps({"ms": ranks[0][0]["ms"],
                  "rank_medians": [statistics.median(o[0]["ms"])
                                   for o in ranks]}))
"""


def turn(root: str, frames: int, out: str) -> dict:
    """One turn in a fresh process at the checkout `root`."""
    proc = subprocess.run(
        [sys.executable, "-c", TURN, str(N_RANKS), str(WARMUP), str(frames),
         out], cwd=os.path.abspath(root), capture_output=True, text=True,
        timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"turn at {root} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, nargs="+",
                    help="roots of the other checkouts")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sharded_ab_probe: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    this = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    order = list(args.other) + ["this", "this"] + list(args.other)[::-1]
    result = {root: [] for root in order}
    with tempfile.TemporaryDirectory() as tmp:
        imgs = []
        for k, root in enumerate(order):
            out = os.path.join(tmp, f"{k}.npy")
            t = turn(this if root == "this" else root, args.frames, out)
            med = statistics.median(t["ms"])
            result[root].append(med)
            imgs.append(np.load(out))
            print(f"{root}: median {med:.3f} ms/frame (rank 0), rank "
                  f"medians {[round(m, 3) for m in t['rank_medians']]}",
                  flush=True)
    for img in imgs[1:]:
        frac = float((np.abs(img - imgs[0]).max(axis=-1) > 0.02).mean())
        assert frac <= 1e-3, f"the turns' images differ: {frac:.4%}"
    print(json.dumps({"card": smi, "other": args.other, "ranks": N_RANKS,
                      "frames": args.frames, "median_ms": result}))


if __name__ == "__main__":
    main()
