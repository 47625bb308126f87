"""BENCHMARK.json and the files it names: the contract's keys, names and
units, every file parses and is found by its name, an added file is
found without an edit, and no module under benchmark/ imports JAX, the
JAX package or (under reference/) the port."""
import ast
import json
import os
import re

import pytest

from benchmark.harness import spec

ROOT = spec.REPO_ROOT
BENCH = spec.benchmark(ROOT)
NAME = spec.NAME
UNIT = spec.UNIT
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e and group in ("configs", "workloads", "per_layer"):
                    assert LINE.match(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in e.get("reduced", []):
                assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for word in BENCH["command"]:
        assert LINE.match(word)


def test_every_config_is_used_and_parses():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        cfg = spec.config(BENCH, c["name"], ROOT)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert {"max_abs_limit", "pixel_tolerance"} <= set(cfg["check"])
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "scenes", f"{cfg['scene']}.py"))


def test_every_traffic_and_metric_file_parses():
    from benchmark.harness import traffic

    for w in BENCH["workloads"]:
        t = traffic.from_spec(spec.traffic(w["traffic"]), 2 ** 31 + 17)
        assert t.name == w["traffic"] and t.frames_in_flight >= 1
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


def test_traffic_seeds_give_the_same_sizes():
    from benchmark.harness import traffic

    for name in ("turn-q3", "static-q3", "static-q1"):
        a = traffic.from_spec(spec.traffic(name), 1)
        b = traffic.from_spec(spec.traffic(name), 2 ** 31 + 5)
        assert (a.period, a.frames_in_flight, a.turn) == (
            b.period, b.frames_in_flight, b.turn)
        # the same poses, whatever pose a seed starts at: the walk sizes
        # the same capacities for every seed
        assert a.poses() == b.poses()
        assert {a.pose(n) for n in range(a.period)} == set(b.poses())
        assert traffic.from_spec(spec.traffic(name), 7) == \
            traffic.from_spec(spec.traffic(name), 7)


def test_an_added_file_is_found_by_name(tmp_path):
    bench_dir = tmp_path / "benchmark"
    (bench_dir / "traffic").mkdir(parents=True)
    (bench_dir / "metrics").mkdir()
    (bench_dir / "configs").mkdir()
    mix = json.loads(open(os.path.join(spec.BENCH_DIR, "traffic",
                                       "static-q1.json")).read())
    mix["name"] = "walk-q2"
    mix["frames_in_flight"] = 2
    (bench_dir / "traffic" / "walk-q2.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "capture_ms.main.py").write_text(
        "def read(run):\n    return 42.0\n")
    cfg = {"name": "new-config", "source": "x"}
    (bench_dir / "configs" / "new-config.json").write_text(json.dumps(cfg))
    bench = {"configs": [{"name": "new-config",
                          "file": "benchmark/configs/new-config.json"}]}
    assert spec.traffic("walk-q2", str(bench_dir))["frames_in_flight"] == 2
    assert spec.metric_reader("capture_ms.main", str(bench_dir))(None) == 42.0
    assert spec.config(bench, "new-config", str(tmp_path)) == cfg


def test_an_added_scene_is_found_by_name(monkeypatch):
    import sys
    import types

    from benchmark.harness import sides

    mod = types.ModuleType("benchmark.scenes.added_scene")
    mod.build = lambda api, models_dir: ("scene", "lights")
    monkeypatch.setitem(sys.modules, "benchmark.scenes.added_scene", mod)
    side = sides.reference()
    scene, cfg, lights = sides.build(
        side, {"scene": "added_scene", "render": {"width": 64}}, None)
    assert (scene, lights, cfg.width) == ("scene", "lights", 64)


def _imports(path):
    """(top-level name, level) of every import in a file."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], 0


def _files(sub=""):
    top = os.path.join(spec.BENCH_DIR, sub)
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("forbidden", ["jax", "jaxlib", "flax",
                                       "crychic_renderer_tpu"])
def test_no_module_imports_jax_or_the_jax_package(forbidden):
    for path in _files():
        for name, level in _imports(path):
            assert level or name != forbidden, path


def test_the_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(spec.BENCH_DIR, "reference")
    for path in _files("reference"):
        depth = os.path.relpath(os.path.dirname(path), ref_dir).count(
            os.sep) + (os.path.dirname(path) != ref_dir)
        for name, level in _imports(path):
            if level:
                # relative imports stay inside the reference package
                assert level - 1 <= depth, path
            else:
                assert name in ("__future__", "contextlib", "dataclasses",
                                "os", "struct", "functools", "typing",
                                "numpy", "torch", "math"), (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    from benchmark.harness import cell

    for name in ("crychic_renderer_tpu_torch.fake", "jaxlike"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "crychic_renderer_tpu.fake",
                        types.ModuleType("crychic_renderer_tpu.fake"))
    assert cell.forbidden_modules() == ["crychic_renderer_tpu.fake"]
