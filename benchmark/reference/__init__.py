"""The benchmark's plain reference: a frozen copy of the port's CPU path
(``render_frame`` with the plain rasterizer and the plain soft PCF, the
device-scene build, the pair pool, the asset decoders, the camera and the
cascade fit), with the CUDA kernels' wrappers cut down to their plain
versions. It imports no part of ``jax``, ``crychic_renderer_tpu`` or
``crychic_renderer_tpu_torch``, and takes nothing the program made: it
builds every table from the benchmark's inputs again. ``render.py`` is its
entry: ``ReferenceFrame``.
"""
