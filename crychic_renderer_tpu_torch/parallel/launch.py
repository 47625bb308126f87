"""Start the ranks of a band-sharded job on this host.

``spawn_ranks(fn, n, backend, device)`` starts n processes
(torch.multiprocessing, start method spawn), joins them in one
torch.distributed process group on a FileStore under a temporary
directory, runs ``fn(*args)`` on every rank and returns the n results in
rank order. spawn pickles ``fn`` by its module and name, so it must be a
module-level function of an importable module. CPU ranks share the
caller's torch intra-op threads (``torch.get_num_threads()``) out among
themselves.

The backend and the device are the caller's choice (both required, no
default): ``nccl`` runs one rank per card (a CUDA device without an index
puts rank r on ``cuda:r``), ``gloo`` serves several ranks on one card
(NCCL refuses two ranks on one GPU) and CPU tensors. A rank's card is
chosen once, in the rank before ``fn`` runs, and made its current
device, so ``fn`` given the caller's ``"cuda"`` allocates there.

``frame_worker`` is the rank body of sharded frames rendered from host
leaves: the tests run it on CPU ranks, ``chip_smoke.py`` on ranks that
share the card (gloo) and on one rank per card (NCCL). On the card it
replays the compiled band frame (parallel/graphs.py) by default.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import pcf, tally
from ..passes import frame as fr
from . import sharded
from .graphs import CompiledBandFrame


def _rank_main(rank: int, n: int, backend: str, store_path: str, device,
               threads: int, call_path: str, results):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None and backend == "nccl":
                device = torch.device("cuda", rank)  # one rank per card
            if device.index is not None:
                torch.cuda.set_device(device)  # where "cuda" allocates
        else:
            # n ranks share the caller's intra-op threads
            torch.set_num_threads(max(1, threads // n))
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, None, traceback.format_exc()))


def spawn_ranks(fn, n: int, backend: str, device, args=(),
                timeout: float = 900.0) -> list:
    """Run fn(*args) on n spawned ranks of one process group; returns the
    results in rank order. Raises RuntimeError with the traceback of the
    first rank that failed (or died, or outran ``timeout`` seconds); every
    process started here is ended before it returns or raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # fn and args reach the ranks through one file, not each process's
        # start pipe: the parent writes that pipe to its end before the next
        # rank starts (so large args would start the ranks one by one), and
        # blocks on it for good if the rank dies before reading it all
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, backend, os.path.join(tmp, "store"),
                                   str(device), torch.get_num_threads(),
                                   call_path, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(got) < n and not errors:
                try:
                    rank, out, err = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        errors[dead[0]] = (f"exited with code "
                                           f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        errors[-1] = f"timed out after {timeout} s"
                    continue
                if err is None:
                    got[rank] = out
                else:
                    errors[rank] = err
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 30)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        rank, err = next(iter(errors.items()))
        raise RuntimeError(f"rank {rank} of {n} ({backend}, {device}) "
                           f"failed:\n{err}")
    return [got[r] for r in range(n)]


def host_leaves(obj) -> dict:
    """A DeviceScene / FrameConstants as a mapping of numpy leaves (nested
    for draws): what DeviceScene.from_numpy / FrameConstants.from_numpy
    rebuild on a rank's device."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = host_leaves(v)
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.cpu().numpy()
        else:
            out[f.name] = v
    return out


def _profile_frames(render, frames: int, top: int = 8) -> dict:
    """torch.profiler (CUDA activity) over `frames` calls of render(): per
    frame, the records and their device ms, and by name (without the
    namespace and arguments) the records and device ms of the raster and
    soft PCF kernels and of the `top` names that took the most."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.removeprefix("void ").replace(
                "(anonymous namespace)::", "").replace("at::native::", "")
            name = name.split(" (")[0].split("(")[0][:60]
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + e.time_range.elapsed_us())
    per = {k: (n / frames, us / 1000.0 / frames)
           for k, (n, us) in by_name.items()}
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])
    return dict(frames=frames,
                records=sum(n for n, _ in per.values()),
                device_ms=sum(ms for _, ms in per.values()),
                kernels={k: v for k, v in per.items()
                         if "raster_tiles" in k or "soft_pcf" in k},
                top=dict(ranked[:top]))


def frame_worker(scenes: list, consts: list, runs: list, device,
                 warmup: int = 0, timed: int = 1) -> list:
    """One rank's part of sharded frames from host leaves.

    scenes, consts: host_leaves of DeviceScenes and FrameConstants. runs:
    (cfg, scene index, consts indices[, opts]). With one consts index the
    job's ranks render one frame over the default group (make_mesh,
    render_frame_sharded); with several they form one replica group per
    index (make_mesh2, render_frames_replicated) and replica r renders
    consts[consts indices[r]]. Each run renders ``warmup`` + ``timed``
    frames of scenes[scene index]. On a CUDA device the frame is compiled
    by default, as every JAX caller jits the band frame: a
    parallel/graphs.CompiledBandFrame captured at the run's first frame
    (its eager frame, the capture and a replay) and replayed for every
    later one; a capture that fails raises in the rank. The CPU renders
    eagerly. opts (a dict, optional): ``compiled`` False renders eagerly
    on the card too; ``packed_atlas`` is render_frame_sharded's (None:
    the JAX rule); ``profile`` N (CUDA) profiles N more frames.

    Per run, returns dict(img: the last frame as numpy, ms: host ms of
    each timed frame until a synchronize (it ends in a collective, so
    every rank waits for the slowest), issue_ms: host ms until each
    timed frame's call returned, launches: this rank's raster launches by
    variant and soft PCF launches ("pcf") over all the run's frames,
    read from the tally (ops/tally.py), frames: how many frames that is,
    gathers and gathered_bytes: per timed frame, overflowed: whether any
    frame dropped pairs), and on a compiled run graph: dict(graphs,
    pool_bytes, capture_ms, launches: what a replay adds to the tally); on
    the card also cache_fills (K6's texture cache over the run) and
    profile."""
    if timed < 1:
        raise ValueError(f"timed {timed}: a run times at least one frame")
    device = torch.device(device)
    cuda = device.type == "cuda"
    # the scenes as sent: a draw sent without static tables renders
    # through the vertex-sharded per-vertex path
    dscenes = [fr.DeviceScene.from_numpy(s, device, attach_statics=False)
               for s in scenes]
    dconsts = [fr.FrameConstants.from_numpy(c, device) for c in consts]
    out = []
    for cfg, si, ci, *rest in runs:
        opts = rest[0] if rest else {}
        if len(ci) == 1:
            mesh = sharded.make_mesh()
            scene, c = dscenes[si], dconsts[ci[0]]
            render = sharded.render_frame_sharded
        else:
            mesh = sharded.make_mesh2(len(ci),
                                      dist.get_world_size() // len(ci))
            scene = sharded.stack_frames([dscenes[si]] * len(ci))
            c = sharded.stack_frames([dconsts[i] for i in ci])
            render = sharded.render_frames_replicated
        render = functools.partial(render,
                                   packed_atlas=opts.get("packed_atlas"))
        compiled = None
        if cuda and opts.get("compiled", True):
            compiled = CompiledBandFrame(render, mesh, device)

        def frame(stats):
            if compiled is not None:
                return compiled(scene, c, cfg, stats)
            return render(scene, c, cfg, mesh, stats)

        counted = tally.snapshot()
        fills = pcf.cache_fills() if cuda else 0
        ms, issue_ms, over, img, gathered = [], [], False, None, None
        for i in range(warmup + timed):
            if i == warmup:
                gathered = tally.snapshot()
            stats = {}
            t0 = time.perf_counter()
            img = frame(stats)
            t1 = time.perf_counter()
            if cuda:
                torch.cuda.synchronize(device)
            if i >= warmup:
                issue_ms.append(1000.0 * (t1 - t0))
                ms.append(1000.0 * (time.perf_counter() - t0))
            over = over or any(bool(v) for v in stats.values())
        gathered = tally.since(gathered)
        res = dict(img=img.cpu().numpy(), ms=ms, issue_ms=issue_ms,
                   overflowed=over, frames=warmup + timed,
                   gathers=gathered.get("gathers", 0) / timed,
                   gathered_bytes=gathered.get("gathered_bytes", 0) / timed)
        if opts.get("profile") and cuda:
            res["profile"] = _profile_frames(lambda: frame({}),
                                             opts["profile"])
            res["frames"] += opts["profile"]
        counted = tally.since(counted)
        res["launches"] = {v: counted.get("raster." + v, 0)
                           for v in tally.RASTER_VARIANTS}
        res["launches"]["pcf"] = counted.get("pcf", 0)
        if cuda:
            res["cache_fills"] = pcf.cache_fills() - fills
        if compiled is not None:
            res["graph"] = dict(graphs=compiled.graphs,
                                pool_bytes=compiled.pool_bytes,
                                capture_ms=compiled.capture_ms,
                                launches=compiled.launches)
            compiled.release()
        out.append(res)
    return out


def render_sharded(scenes: list, consts: list, runs: list, n: int,
                   backend: str, device, warmup: int = 0,
                   timed: int = 1, timeout: float = 900.0) -> list:
    """frame_worker on n spawned ranks, from DeviceScenes and
    FrameConstants on any device (sent as host leaves and rebuilt on each
    rank's ``device``). Returns, per rank, frame_worker's list."""
    return spawn_ranks(frame_worker, n, backend, device,
                       ([host_leaves(s) for s in scenes],
                        [host_leaves(c) for c in consts], runs, str(device),
                        warmup, timed), timeout)
