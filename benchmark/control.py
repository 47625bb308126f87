"""The lower-precision control of the comparison that decides ``correct``:
the reference put in the program's place and computed in the precision
next below the configuration's (TF32 for float32 with TF32 off),
judged against the float32 reference as a
run judges the program, at the cell's own size and poses.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] \\
        [--frame-count N]

For each seed it renders the frames a run compares (the frames drawn from
the seed, and frame N standing in for a window's last, N the number of
frames a window of run_seconds holds at the cell's rate) both ways and
prints one JSON line per seed: each frame's numbers (check.numbers) and
the largest max_abs, beside the configuration's limit. The benchmark's runs do not
run it; ``tests/test_bench_control.py`` holds it to the limit on the card.
"""
import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(bench: dict, workload: dict, seed: int,
                     last_frame: int, device, size: dict = None) -> dict:
    """{frame: the check's numbers (check.numbers) of the TF32 reference
    against the float32 reference} at the frames a run of this seed
    compares."""
    import numpy as np

    from benchmark.harness import cell, check, sides, spec
    from benchmark.harness import traffic as traffic_mod
    from benchmark.reference.render import ReferenceFrame

    config = spec.config(bench, workload["config"])
    tr = traffic_mod.from_spec(spec.traffic(workload["traffic"]), seed)
    keep = check.sample_frames(np.random.default_rng([seed, 1]),
                               cell.COMPARED, cell.SAMPLE_BELOW)
    tol = config["check"]["pixel_tolerance"]
    out = {}
    with tempfile.TemporaryDirectory(prefix="crychic-control-") as tmp:
        models, textures, cube = cell._assets(config, tmp, seed, bool(size))
        side = sides.reference()
        scene, cfg, lights = sides.build(side, config, models, size)
        ref = ReferenceFrame(scene, cfg, lights, device, asset_dir=textures,
                             sky_cubemap_path=cube)
        for n in keep + [last_frame]:
            cam = traffic_mod.camera(side.Camera, tr, tr.pose(n),
                                     cfg.width / cfg.height)
            want = ref.render(cam, tr.time(n))
            low = ref.render(cam, tr.time(n), tf32=True)
            out[n] = check.numbers(low, want, tol)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frame-count", type=int, default=400)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    workload = spec.workload(bench, args.workload)
    limit = spec.config(bench, workload["config"])["check"][
        "max_abs_limit"]
    for seed in args.seeds:
        frames = control_readings(bench, workload, seed,
                                  args.frame_count - 1,
                                  torch.device("cuda", 0))
        print(json.dumps({
            "workload": args.workload, "seed": seed, "frames": frames,
            "largest": max(v["max_abs"] for v in frames.values()),
            "limit": limit}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main())
