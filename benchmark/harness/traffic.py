"""The one traffic generator: a camera path and a frame loop from a
traffic file's parameters and the run's seed.

A traffic file (``traffic/<name>.json``) holds:

- ``frames_in_flight``: F. Frame n is queued after the host has waited on
  the event recorded behind frame n - F (the reference's
  gNumFrameResources fence wait).
- ``frame_dt_s``: the time step of the frame's ``total_time``.
- ``position``: the camera's position.
- ``heading_deg``: the base heading (a turn about +y from the
  reference's look along +z).
- ``turn_deg_per_frame``, ``period_frames``: the path's k-th pose turns
  the camera by k x turn from the base heading, for k < period; frame n
  takes pose (n + s) mod period, where the seed draws the start s.
- ``lens``: ``fov_y_rad``, ``near``, ``far`` (the aspect is the frame's).
- ``walk_capacities``: in set-up, walk every pose of the period with the
  Renderer's ``ensure_capacity``, so the window never regrows a capacity.

Every seed gives the same frame sizes and the same poses; only the pose
the path starts at changes, so every seed asks the same work of the
capacities the path's walk sizes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pose:
    position: tuple  # (x, y, z)
    heading: float  # radians about +y


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    frames_in_flight: int
    frame_dt_s: float
    base: Pose  # the path's pose 0
    start: int  # the path's pose of frame 0, drawn from the seed
    turn: float  # radians per frame
    period: int
    fov_y: float
    near: float
    far: float
    walk_capacities: bool

    def pose(self, n: int) -> Pose:
        """The camera pose of frame n (n >= 0)."""
        return self._path((n + self.start) % self.period)

    def _path(self, k: int) -> Pose:
        return Pose(self.base.position, self.base.heading + k * self.turn)

    def poses(self) -> list:
        """The path's distinct poses in path order from pose 0: the same
        list for every seed."""
        return [self._path(k) for k in range(self.period)]

    def time(self, n: int) -> float:
        return n * self.frame_dt_s


def from_spec(spec: dict, seed: int) -> Traffic:
    """The traffic of a parsed traffic file for this seed."""
    heading = math.radians(float(spec.get("heading_deg", 0.0)))
    position = tuple(float(p) for p in spec["position"])
    lens = spec["lens"]
    frames = int(spec["frames_in_flight"])
    period = int(spec.get("period_frames", 1))
    if frames < 1 or period < 1:
        raise ValueError(f"traffic {spec['name']}: frames_in_flight and "
                         f"period_frames must be at least 1")
    return Traffic(
        name=spec["name"], frames_in_flight=frames,
        frame_dt_s=float(spec["frame_dt_s"]),
        base=Pose(position, heading),
        start=int(np.random.default_rng(seed).integers(period)),
        turn=math.radians(float(spec.get("turn_deg_per_frame", 0.0))),
        period=period, fov_y=float(lens["fov_y_rad"]),
        near=float(lens["near"]), far=float(lens["far"]),
        walk_capacities=bool(spec.get("walk_capacities", False)))


def camera(camera_cls, traffic: Traffic, pose: Pose, aspect: float):
    """A fresh camera of the given class (the port's or the reference's
    Camera) at the pose: the lens, the position, then the heading as one
    rotate_y from the reference's look along +z."""
    cam = camera_cls()
    cam.set_lens(traffic.fov_y, aspect, traffic.near, traffic.far)
    cam.set_position(*pose.position)
    cam.rotate_y(pose.heading)
    return cam
