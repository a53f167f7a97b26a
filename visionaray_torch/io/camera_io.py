"""Camera save/load to a small text file (port of io/camera_io.py;
viewer.cpp:690-712 'u'/'v' keys).

Format (whitespace separated, one value per token):
    eye.x eye.y eye.z
    center.x center.y center.z
    up.x up.y up.z
    fovy aspect z_near z_far
"""

from __future__ import annotations

import numpy as np

from visionaray_torch.core.camera import Pinhole
from visionaray_torch.device import to_numpy


def _host(x):
    return to_numpy(x).astype(np.float64).ravel()


def save_camera(path: str, cam: Pinhole):
    vals = np.concatenate([
        _host(cam.eye), _host(cam.center), _host(cam.up),
        [float(cam.fovy), float(cam.aspect), float(cam.z_near),
         float(cam.z_far)],
    ])
    with open(path, "w") as f:
        f.write(" ".join(repr(float(v)) for v in vals) + "\n")


def load_camera(path: str, device="cuda") -> Pinhole:
    with open(path) as f:
        vals = [float(t) for t in f.read().split()]
    if len(vals) < 13:
        raise ValueError(f"bad camera file: {path}")
    return Pinhole.create(
        eye=vals[0:3], center=vals[3:6], up=vals[6:9], fovy=vals[9],
        aspect=vals[10], z_near=vals[11], z_far=vals[12], device=device)
