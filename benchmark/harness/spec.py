"""The cell's spec from ``BENCHMARK.json``: the workload, its
configuration file, its traffic file and the readers of its per-layer
metrics, each found by the name the spec gives."""
from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = REPO_ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = REPO_ROOT) -> dict:
    """The parsed file of the configuration `name`."""
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    """The parsed traffic file traffic/<name>.json."""
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The read(run) function of metrics/<name>.py, loaded by path."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, kind: str, cell: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that the cell
    reports: those without a workloads key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
