"""visionaray_torch: the PyTorch / CUDA port of visionaray_tpu.

The package mirrors visionaray_tpu's layout (core/, ops/, shading/,
kernels/, sched/, scenes/, diff/) and keeps its public layouts: (N, 3)
rays, HitRecord fields, (H, W, 4) images with row 0 at the bottom.  It
imports torch and numpy only.

Entry points take a ``device`` argument that defaults to CUDA and raise when
no GPU is present; tests pass ``device="cpu"``.  The hand-written kernels
(ClusterBVH traversal, ``ops/cuda/traverse_binned.cu`` and
``traverse_coherent.cu``; the LBVH tier's walk, ``traverse_lbvh.cu``) are
built with nvcc at first use; on CPU tensors their wrappers run the plain
PyTorch versions instead.
"""

from visionaray_torch.core.camera import MatrixCamera, Pinhole
from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.core.types import AABB, HitRecord, Ray, ResultRecord
from visionaray_torch.device import resolve_device
from visionaray_torch.sched.render import RenderTarget, SchedParams, render
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials, MaterialType

__all__ = [
    "Ray", "HitRecord", "ResultRecord", "AABB",
    "Pinhole", "MatrixCamera",
    "Scene", "TriangleMesh", "Spheres", "Planes",
    "Materials", "MaterialType", "PointLights",
    "render", "RenderTarget", "SchedParams", "resolve_device",
]
