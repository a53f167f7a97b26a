"""The volume march's CUDA kernel (ops/cuda/volume_march.cu) vs its plain
PyTorch version (kernels/volume.py::march_plain), on the card: the
primary rays of volume_scene(32) and multi_volume_scene(32, 3), rays
inside a box, axis-aligned rays on box planes (the NaN slab case), a long
thin box at the 512-step cap, a permuted volume array, the counting form,
the launch counts of render(algo="volume"), and the refusal of a gradient.

Marked ``cuda``: each test skips itself when torch.cuda.is_available() is
False (decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda_volume.py -q

The kernel is built with -fmad=false and follows the plain version's
operation order, so hit and depth must be equal and the colour within
1e-5 (bit-equal is expected).
"""

import dataclasses

import numpy as np
import pytest
import torch

from visionaray_torch.kernels import volume as tvol
from visionaray_torch.ops import traverse as trav
from visionaray_torch.scenes import volume_demo
from visionaray_torch.sched import render as trender
from visionaray_torch.sched.render import _pixel_grid

pytestmark = pytest.mark.cuda
BG = (0.1, 0.4, 1.0, 1.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the volume march kernel has no CPU or "
                    "interpret mode (chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


def _same(o, d, vols):
    bg = torch.tensor(BG, device=o.device)
    steps = torch.zeros(o.shape[0], dtype=torch.int32, device=o.device)
    kc, kh, kd = tvol.volume_march(o, d, vols, bg, steps=steps)
    pc, ph, pd = tvol.march_plain(o, d, vols, bg)
    torch.cuda.synchronize()
    assert torch.equal(kh, ph)
    assert torch.equal(kd, pd)
    assert float((kc - pc).abs().max()) <= 1e-5
    assert int(steps.max()) <= tvol.MAX_STEPS * vols.num_volumes
    return kc, steps


@pytest.mark.parametrize("make", [
    lambda dev: volume_demo.volume_scene(32, device=dev),
    lambda dev: volume_demo.multi_volume_scene(32, 3, device=dev)],
    ids=["single", "multi"])
def test_primary_rays(cuda, make):
    scene, cam = make(cuda)
    x, y = _pixel_grid(48, 48, cuda)
    ray = cam.primary_rays(x, y, 48, 48)
    color, steps = _same(ray.ori.contiguous(), ray.dir.contiguous(),
                         scene.volumes)
    assert int(steps.sum()) > 0
    vols = scene.volumes
    perm = torch.arange(vols.num_volumes - 1, -1, -1, device=cuda)
    permuted = tvol.Volumes(vols.lo[perm], vols.hi[perm], vols.texels[perm],
                            vols.transfer[perm])
    bg = torch.tensor(BG, device=cuda)
    again = tvol.volume_march(ray.ori.contiguous(), ray.dir.contiguous(),
                              permuted, bg)[0]
    assert torch.equal(again, color)


def test_edge_rays(cuda):
    scene, _ = volume_demo.volume_scene(16, device=cuda)
    o = torch.tensor([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0], [-1.0, 0.3, -2.0],
                      [0.2, 1.0, 3.0], [-1.0, -1.0, -3.0],
                      [-1.0001, 0.3, -2.0], [0.5, -3.0, 0.5]], device=cuda)
    d = torch.tensor([[0.3, -0.2, 0.9], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                      [0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                      [0.0, 1.0, 0.0]], device=cuda)
    _same(o, d, scene.volumes)


def test_step_cap(cuda):
    rng = np.random.default_rng(5)
    texels = rng.uniform(0.0, 1.0, (16, 16, 16)).astype(np.float32)
    t = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    transfer = np.stack([t, 1 - t, 0.5 + 0 * t, 0.02 * t], -1)
    vols = tvol.Volumes.create([[-1.0, -0.01, -0.01]], [[1.0, 0.01, 0.01]],
                               texels, transfer, device=cuda)
    o = torch.tensor([[-2.0, 0.0, 0.0], [2.0, 0.001, 0.0]], device=cuda)
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], device=cuda)
    _, steps = _same(o, d, vols)
    assert steps.tolist() == [tvol.MAX_STEPS, tvol.MAX_STEPS]


def test_render_launches_once_and_refuses_grad(cuda):
    scene, cam = volume_demo.volume_scene(32, device=cuda)
    trav.reset_launch_counts()
    rt = trender.render(scene, cam, 64, 64, algo="volume")
    torch.cuda.synchronize()
    assert trav.LAUNCHES["volume_march"] == 1
    assert trav.ENTRY_LAUNCHES["vsnray_volume_march"] == 1
    assert sum(trav.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(rt.color).all())
    texels = scene.volumes.texels.clone().requires_grad_()
    s = dataclasses.replace(scene, volumes=dataclasses.replace(
        scene.volumes, texels=texels))
    with pytest.raises(NotImplementedError, match="6b"):
        trender.render(s, cam, 8, 8, algo="volume")
