"""visionaray_torch: the PyTorch / CUDA port of visionaray_tpu.

The package mirrors visionaray_tpu's layout (core/, ops/, shading/,
kernels/, sched/, scenes/) and keeps its public layouts: (N, 3) rays,
HitRecord fields, (H, W, 4) images with row 0 at the bottom.  It imports
torch and numpy only.

Entry points take a ``device`` argument that defaults to CUDA and raise when
no GPU is present; tests pass ``device="cpu"``.  The hand-written kernels
(ClusterBVH traversal, ``ops/cuda/traverse_binned.cu`` and
``traverse_coherent.cu``) are built with nvcc at first use; on CPU tensors
their wrapper runs the plain PyTorch version instead.
"""

from visionaray_torch.device import resolve_device

__all__ = ["resolve_device"]
