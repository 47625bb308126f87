"""torch's intra-op threads for the port's CPU tests.

pytest-xdist runs the suite on several workers, and each worker's torch
would otherwise use a thread per core: with 6 workers on 8 cores, 48
threads fight for 8 cores and the torch tests run many times slower than
alone. Every tests/test_torch_*.py calls cap_torch_threads() at import,
which shares the cores out among the workers
(PYTEST_XDIST_WORKER_COUNT; 1 when the tests run without xdist).
"""
import os

import torch


def cap_torch_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n
