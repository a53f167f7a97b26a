"""Headless camera manipulators: arcball rotate, pan, zoom (port of
io/manip.py; the reference's src/common/manip/).

Pure functions of (camera, mouse events) -> camera, with no window
system, for notebooks, remote viewers and turntable scripts:

- ``Arcball``: the screen-to-ball projection and the accumulated
  quaternion (arcball.cpp);
- ``ArcballManipulator``: rotates the eye about the center on a virtual
  sphere (arcball_manipulator.cpp);
- ``PanManipulator``: translates eye and center in the view plane
  (pan_manipulator.cpp);
- ``ZoomManipulator``: dollies along the view axis (zoom_manipulator.cpp).

Window coordinates have y down, as mouse events do; ``Arcball.project``
negates y as arcball.cpp does.  The camera is the port's ``Pinhole``; the
manipulators compute on its device.

Usage::

    manip = ArcballManipulator(cam, viewport=(0, 0, 800, 600))
    manip.handle_mouse_down(400, 300)
    manip.handle_mouse_move(420, 310)   # drag
    manip.handle_mouse_up()
    cam = manip.camera                  # the updated Pinhole
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from visionaray_torch.core import quat as q
from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.vecmath import cross, normalize


@dataclasses.dataclass
class Arcball:
    """Screen-to-ball projection and the accumulated rotation."""

    radius: float = 1.0
    down_pos: Any = None           # (3,) ball coordinates at mouse-down
    rotation: Any = None           # accumulated unit quaternion
    down_rotation: Any = None      # the rotation at mouse-down

    def __post_init__(self):
        if self.down_pos is None:
            self.down_pos = torch.zeros(3, dtype=torch.float32)
        if self.rotation is None:
            self.rotation = q.identity()
        if self.down_rotation is None:
            self.down_rotation = q.identity()

    def project(self, x: float, y: float,
                viewport: Tuple[int, int, int, int]):
        """Window (x, y) on the arcball: outside the ball pinned to its
        silhouette circle (z = 0), inside lifted onto the sphere."""
        vx, vy, w, h = viewport
        x = x - vx
        y = y - vy
        u = (x - 0.5 * w) / (self.radius * 0.5 * w)
        v = -(y - 0.5 * h) / (self.radius * 0.5 * h)
        d = u * u + v * v
        if d > 1.0:
            inv = 1.0 / math.sqrt(d)
            return torch.tensor([u * inv, v * inv, 0.0], dtype=torch.float32)
        return torch.tensor([u, v, math.sqrt(1.0 - d)], dtype=torch.float32)


@dataclasses.dataclass
class CameraManipulator:
    """The drag state machine (camera_manipulator.cpp)."""

    camera: Pinhole
    viewport: Tuple[int, int, int, int] = (0, 0, 1, 1)
    dragging: bool = False

    def handle_mouse_down(self, x: float, y: float) -> None:
        self.dragging = True
        self._on_down(x, y)

    def handle_mouse_move(self, x: float, y: float) -> None:
        if self.dragging:
            self._on_drag(x, y)

    def handle_mouse_up(self) -> None:
        self.dragging = False

    def _on_down(self, x, y):  # pragma: no cover - overridden
        pass

    def _on_drag(self, x, y):  # pragma: no cover - overridden
        pass


@dataclasses.dataclass
class ArcballManipulator(CameraManipulator):
    """Rotate the eye about the center (arcball_manipulator.cpp)."""

    ball: Arcball = dataclasses.field(default_factory=Arcball)

    def _on_down(self, x, y):
        self.ball.down_pos = self.ball.project(x, y, self.viewport)
        self.ball.down_rotation = self.ball.rotation

    def _on_drag(self, x, y):
        cam = self.camera
        curr = self.ball.project(x, y, self.viewport)
        self.ball.rotation = q.mul(
            q.rotation_from_to(self.ball.down_pos, curr),
            self.ball.down_rotation)
        # rotate the canonical eye (0, 0, distance) by the conjugate, then
        # look at the center again
        rm = q.to_matrix4(q.conjugate(self.ball.rotation)).to(cam.device)
        eye = rm[:3, :3] @ torch.stack([
            torch.zeros((), device=cam.device),
            torch.zeros((), device=cam.device), cam.distance])
        eye = eye + cam.center
        up = rm[:3, 1]   # column 1: the rotated +Y
        self.camera = cam.look_at(eye, cam.center, up)


@dataclasses.dataclass
class PanManipulator(CameraManipulator):
    """Translate eye and center in the view plane (pan_manipulator.cpp)."""

    last_pos: Tuple[float, float] = (0.0, 0.0)

    def _on_down(self, x, y):
        self.last_pos = (x, y)

    def _on_drag(self, x, y):
        cam = self.camera
        _, _, w, h = self.viewport
        dx = (self.last_pos[0] - x) / w
        dy = -(self.last_pos[1] - y) / h
        s = 2.0 * float(cam.distance)
        zaxis = normalize(cam.eye - cam.center)
        yaxis = cam.up
        xaxis = cross(yaxis, zaxis)
        d = (dx * s) * xaxis + (dy * s) * yaxis
        self.camera = cam.look_at(cam.eye + d, cam.center + d, cam.up)
        self.last_pos = (x, y)


@dataclasses.dataclass
class ZoomManipulator(CameraManipulator):
    """Dolly along the view axis (zoom_manipulator.cpp)."""

    last_pos: Tuple[float, float] = (0.0, 0.0)

    def _on_down(self, x, y):
        self.last_pos = (x, y)

    def _on_drag(self, x, y):
        cam = self.camera
        _, _, _, h = self.viewport
        dy = -(self.last_pos[1] - y) / h
        s = 2.0 * float(cam.distance) * dy
        direction = normalize(cam.eye - cam.center)
        self.camera = cam.look_at(cam.eye - direction * s, cam.center,
                                  cam.up)
        self.last_pos = (x, y)
