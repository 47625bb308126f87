"""CRYCHIC renderer, PyTorch + CUDA port of ``crychic_renderer_tpu``.

The JAX package beside this one is the reference. This package renders the
same scenes with the same ``RenderConfig`` into the same image, with torch
tensors on an explicit device and the raster kernel written by hand in
CUDA C++ for Hopper (``csrc/raster.cu``). Module paths and function names
match the JAX package, so every function has its counterpart by name.

Layers (bottom-up):

- ``utils``, ``models``, ``config``, ``io`` — host-side numpy, carried over
  from the JAX package with jax removed (that package imports jax at its
  top level, so not even its numpy modules can be shared).
- ``ops``    — device functions on tensors: clipping, rasterizer binning,
  the raster kernel wrapper (``ops.raster``), texture sampling, PCF, SSAO,
  PBR shading.
- ``passes`` — ``render_frame``, the deferred frame in CRYCHIC::Draw order.
- ``parallel`` — ``render_frame_sharded``, the frame split into screen
  bands over the ranks of a torch.distributed group, and the launcher
  that starts the ranks.
- ``app``    — ``Renderer`` (host orchestration) and the ``run`` CLI.

Importing the package pins float32 semantics the way the JAX package pins
its matmul precision: TF32 on Hopper rounds to ~10 mantissa bits, which
would move vertices and flip triangle ids exactly as bf16 did on the MXU.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
