"""The two sides a cell's inputs are handed to: the program (the port's
public scene, config and camera types) and the reference (their frozen
copies under ``benchmark/reference``). A scene builder of ``scenes/``
computes the numbers once per side through these types, so both sides
get the same inputs."""
from __future__ import annotations

import dataclasses
import importlib
import types


def _side(root: str) -> types.SimpleNamespace:
    scene = importlib.import_module(f"{root}.models.scene")
    materials = importlib.import_module(f"{root}.models.materials")
    camera = importlib.import_module(f"{root}.models.camera")
    config = importlib.import_module(f"{root}.config")
    return types.SimpleNamespace(
        make_item=scene.make_item, flatten_items=scene.flatten_items,
        Scene=scene.Scene, LAYER_OPAQUE=scene.LAYER_OPAQUE,
        LAYER_OPAQUE_SHADOW=scene.LAYER_OPAQUE_SHADOW,
        LAYER_SKY=scene.LAYER_SKY, LAYER_DEBUG=scene.LAYER_DEBUG,
        Material=materials.Material, MaterialBank=materials.MaterialBank,
        Lights=materials.Lights, Camera=camera.Camera,
        RenderConfig=config.RenderConfig)


def program():
    """The port's types."""
    return _side("crychic_renderer_tpu_torch")


def reference():
    """The reference's types."""
    return _side("benchmark.reference")


def build(side, config: dict, models_dir, size: dict = None):
    """(scene, render cfg, lights) of a configuration for one side; `size`
    replaces render settings (the CPU tests' small frames)."""
    builder = importlib.import_module(f"benchmark.scenes.{config['scene']}")
    scene, lights = builder.build(side, models_dir)
    cfg = side.RenderConfig(**config["render"])
    if size:
        cfg = dataclasses.replace(cfg, **size)
    return scene, cfg, lights
