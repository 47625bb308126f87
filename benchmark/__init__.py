"""The benchmark of the PyTorch + CUDA port (``crychic_renderer_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line last. What a cell runs is data: ``configs/<name>.json``
(the scene builder of ``scenes/`` and the render settings), and
``traffic/<name>.json`` (the camera path and the frames in flight), read
by one generator (``harness/traffic.py``); each per-layer metric is a
reader of its own, ``metrics/<name>.py``. The plain reference that decides
``correct`` is ``reference/``, a frozen copy of the port's CPU path that
imports nothing of the port.
"""
