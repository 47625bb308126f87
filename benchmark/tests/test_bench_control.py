"""The control on the card: the reference computed in TF32 (the
precision next below the configurations' float32 with TF32 off), put in
the program's place at each cell's own size and poses, fails the
comparison that decides ``correct``. Card-only (marked cuda):

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q
"""
import pytest
import torch

from benchmark import control
from benchmark.harness import spec

BENCH = spec.benchmark(spec.REPO_ROOT)
# seeds whose readings the limits were set from (PERF.md)
SEEDS = {"c5-turn-q3": 2147486601, "c4soft-static-q3": 2147486603,
         "c4-static-q1": 2147486603}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SEEDS))
def test_the_tf32_control_fails_the_check(card, cell):
    workload = spec.workload(BENCH, cell)
    limit = spec.config(BENCH, workload["config"], spec.REPO_ROOT)[
        "check"]["max_abs_limit"]
    got = control.control_readings(BENCH, workload, SEEDS[cell], 399, card)
    assert max(v["max_abs"] for v in got.values()) > limit
