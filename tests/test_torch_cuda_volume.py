"""The volume march's CUDA kernel (ops/cuda/volume_march.cu) vs its plain
PyTorch version (kernels/volume.py::march_plain), on the card: the
primary rays of volume_scene(32) and multi_volume_scene(32, 3), rays
inside a box, axis-aligned rays on box planes (the NaN slab case), a long
thin box at the 512-step cap, a permuted volume array, the counting form,
the launch counts of render(algo="volume"); and the backward kernel
(ops/cuda/volume_march_bwd.cu) against the plain version's autograd, on
the demo scenes and on tables too large for a block's default 48 KiB of
shared memory (the transfer gradient alone, no texel atomics), the
refusal of tables larger than a block may hold, the tie rule of the
opacity clip at a = 0, and the gradients to rays and boxes (``o``, ``d``,
``lo``, ``hi``) of a loss that reads colour and depth.

Marked ``cuda``: each test skips itself when torch.cuda.is_available() is
False (decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda_volume.py -q

The kernel is built with -fmad=false and follows the plain version's
operation order, so hit and depth must be equal and the colour within
1e-5 (bit-equal is expected).  The backward kernel's texel and transfer
gradients must be within relative L2 1e-4 of the plain version's, the
background's within 1e-5 relative (its atomic adds reorder the sums);
the ray and box gradients within relative L2 1e-4 at a cosine of at
least 0.9999, as the texels' are held in chip_smoke.py.
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


def test_render_launches_once(cuda):
    scene, cam = volume_demo.volume_scene(32, device=cuda)
    trav.reset_launch_counts()
    rt = trender.render(scene, cam, 64, 64, algo="volume")
    torch.cuda.synchronize()
    assert trav.LAUNCHES["volume_march"] == 1
    assert trav.ENTRY_LAUNCHES["vsnray_volume_march"] == 1
    assert sum(trav.LAUNCHES.values()) == 1
    assert bool(torch.isfinite(rt.color).all())


def _cos(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.parametrize("make", [
    lambda dev: volume_demo.volume_scene(32, device=dev),
    lambda dev: volume_demo.multi_volume_scene(32, 3, device=dev)],
    ids=["single", "multi"])
def test_backward_ray_and_box_gradients(cuda, make):
    """One backward launch gives dL/do, dL/dd, dL/dlo and dL/dhi of a loss
    over colour and depth, against the plain version's autograd."""
    scene, cam = make(cuda)
    x, y = _pixel_grid(48, 48, cuda)
    ray = cam.primary_rays(x, y, 48, 48)
    rng = np.random.default_rng(4)
    w = torch.tensor(rng.uniform(-1.0, 1.0, (48 * 48, 4)).astype(np.float32),
                     device=cuda)
    wd = torch.tensor(rng.uniform(-1.0, 1.0, 48 * 48).astype(np.float32),
                      device=cuda)
    bg = torch.tensor(BG, device=cuda)
    grads = []
    trav.reset_launch_counts()
    for march in (tvol.volume_march, tvol.march_plain):
        leaves = [ray.ori.detach().clone().requires_grad_(),
                  ray.dir.detach().clone().requires_grad_(),
                  scene.volumes.lo.clone().requires_grad_(),
                  scene.volumes.hi.clone().requires_grad_()]
        vols = dataclasses.replace(scene.volumes, lo=leaves[2],
                                   hi=leaves[3])
        color, _, depth = march(leaves[0], leaves[1], vols, bg)
        ((color * w).sum() + (depth * wd).sum()).backward()
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    assert trav.LAUNCHES["volume_march_bwd"] == 1
    for got, ref in zip(*grads):
        assert bool(torch.isfinite(got).all())
        assert float(ref.abs().max()) > 0
        assert _rel(got, ref) <= 1e-4
        assert _cos(got, ref) >= 0.9999


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _kernel_and_plain_grads(o, d, vols, w):
    out = []
    for march in (tvol.volume_march, tvol.march_plain):
        tex = vols.texels.clone().requires_grad_()
        tr = vols.transfer.clone().requires_grad_()
        bg = torch.tensor(BG, device=o.device, requires_grad=True)
        color, _, _ = march(o, d, dataclasses.replace(
            vols, texels=tex, transfer=tr), bg)
        (color * w).sum().backward()
        out.append((color.detach(), tex.grad, tr.grad, bg.grad))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("make", [
    lambda dev: volume_demo.volume_scene(32, device=dev),
    lambda dev: volume_demo.multi_volume_scene(32, 3, device=dev)],
    ids=["single", "multi"])
def test_backward_kernel_matches_plain(cuda, make):
    scene, cam = make(cuda)
    x, y = _pixel_grid(48, 48, cuda)
    ray = cam.primary_rays(x, y, 48, 48)
    o, d = ray.ori.contiguous(), ray.dir.contiguous()
    w = torch.tensor(np.random.default_rng(3).uniform(
        -1.0, 1.0, (o.shape[0], 4)).astype(np.float32), device=cuda)
    trav.reset_launch_counts()
    (kc, ktex, ktr, kbg), (pc, ptex, ptr, pbg) = _kernel_and_plain_grads(
        o, d, scene.volumes, w)
    assert trav.LAUNCHES["volume_march"] == 1
    assert trav.LAUNCHES["volume_march_bwd"] == 1
    assert trav.ENTRY_LAUNCHES["vsnray_volume_march_bwd"] == 1
    assert float((kc - pc).abs().max()) <= 1e-5
    assert _rel(ktex, ptex) <= 1e-4
    assert _rel(ktr, ptr) <= 1e-4
    torch.testing.assert_close(kbg, pbg, rtol=1e-5, atol=0)


def test_backward_tie_rule_at_zero(cuda):
    """Constant density 0.25 through a transfer whose alpha is 0
    everywhere: every step's opacity argument is exactly 0, so the alpha
    entries get half the unclamped gradient (1.6 in all, not 3.2; the CPU
    test tests/test_torch_volume_grad.py derives it), as the plain
    version's torch.minimum/maximum clip and jnp.clip give."""
    texels = np.full((4, 4, 4), 0.25, np.float32)
    transfer = np.zeros((4, 4), np.float32)
    transfer[:, :3] = 0.5
    vols = tvol.Volumes.create([[-1, -1, -1]], [[1, 1, 1]], texels,
                               transfer, device=cuda)
    o = torch.tensor([[0.0, 0.0, -3.0]], device=cuda)
    d = torch.tensor([[0.0, 0.0, 1.0]], device=cuda)
    w = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=cuda)
    (_, _, ktr, _), (_, _, ptr, _) = _kernel_and_plain_grads(o, d, vols, w)
    torch.testing.assert_close(ktr, ptr, rtol=1e-5, atol=1e-7)
    assert abs(float(ktr[0, 0, 3] + ktr[0, 1, 3]) - 1.6) <= 1e-5


def _long_tables(vols, T):
    """``vols`` with its transfer tables resampled to T entries."""
    tr = torch.nn.functional.interpolate(
        vols.transfer.permute(0, 2, 1), size=T, mode="linear",
        align_corners=True).permute(0, 2, 1).contiguous()
    return dataclasses.replace(vols, transfer=tr)


def test_backward_large_table_transfer_only(cuda):
    """Two volumes with 1,024-entry tables: 8,192 f64 entries, 64 KiB of
    shared memory, above the 48 KiB a block gets unasked.  Only the
    transfer requires grad, so the kernel takes no texel atomics and the
    texels get no gradient."""
    scene, cam = volume_demo.multi_volume_scene(32, 2, device=cuda)
    vols = _long_tables(scene.volumes, 1024)
    x, y = _pixel_grid(48, 48, cuda)
    ray = cam.primary_rays(x, y, 48, 48)
    o, d = ray.ori.contiguous(), ray.dir.contiguous()
    w = torch.tensor(np.random.default_rng(5).uniform(
        -1.0, 1.0, (o.shape[0], 4)).astype(np.float32), device=cuda)
    bg = torch.tensor(BG, device=cuda)
    grads = []
    trav.reset_launch_counts()
    for march in (tvol.volume_march, tvol.march_plain):
        tr = vols.transfer.clone().requires_grad_()
        tex = vols.texels.clone()
        color, _, _ = march(o, d, dataclasses.replace(
            vols, texels=tex, transfer=tr), bg)
        (color * w).sum().backward()
        assert tex.grad is None
        grads.append(tr.grad)
    torch.cuda.synchronize()
    assert trav.LAUNCHES["volume_march_bwd"] == 1
    assert float(grads[1].abs().max()) > 0
    assert _rel(grads[0], grads[1]) <= 1e-4


def test_backward_refuses_oversized_tables(cuda):
    """Eight 1,024-entry tables: 32,768 f64 entries, more than the shared
    memory a block may opt in to (29,056 on the H100): the launch is
    refused with an error, never run on a truncated accumulator."""
    scene, cam = volume_demo.multi_volume_scene(16, 8, device=cuda)
    vols = _long_tables(scene.volumes, 1024)
    x, y = _pixel_grid(8, 8, cuda)
    ray = cam.primary_rays(x, y, 8, 8)
    tr = vols.transfer.clone().requires_grad_()
    color, _, _ = tvol.volume_march(
        ray.ori.contiguous(), ray.dir.contiguous(),
        dataclasses.replace(vols, transfer=tr), torch.tensor(BG, device=cuda))
    with pytest.raises(RuntimeError, match="vsnray_volume_march_bwd"):
        color.sum().backward()


def test_backward_table_at_the_optin_limit(cuda):
    """Eight 908-entry tables: 29,056 f64 entries, exactly the 232,448
    bytes a block may opt in to on the H100 (the transfer alone, no box
    sums): the launch runs, and its gradient is the plain version's."""
    scene, cam = volume_demo.multi_volume_scene(16, 8, device=cuda)
    vols = _long_tables(scene.volumes, 908)
    x, y = _pixel_grid(32, 32, cuda)
    ray = cam.primary_rays(x, y, 32, 32)
    o, d = ray.ori.contiguous(), ray.dir.contiguous()
    w = torch.tensor(np.random.default_rng(7).uniform(
        -1.0, 1.0, (o.shape[0], 4)).astype(np.float32), device=cuda)
    bg = torch.tensor(BG, device=cuda)
    grads = []
    trav.reset_launch_counts()
    for march in (tvol.volume_march, tvol.march_plain):
        tr = vols.transfer.clone().requires_grad_()
        color, _, _ = march(o, d, dataclasses.replace(vols, transfer=tr), bg)
        (color * w).sum().backward()
        grads.append(tr.grad)
    torch.cuda.synchronize()
    assert trav.LAUNCHES["volume_march_bwd"] == 1
    assert float(grads[1].abs().max()) > 0
    assert _rel(grads[0], grads[1]) <= 1e-4


@pytest.mark.parametrize("make", [
    lambda dev: volume_demo.volume_scene(32, device=dev),
    lambda dev: volume_demo.multi_volume_scene(32, 3, device=dev)],
    ids=["single", "multi"])
def test_backward_transfer_adds_counted(cuda, make):
    """The counting argument: the shared-memory adds the transfer gradient
    issued, at least one and at most the 8 a step of a design without the
    per-thread and per-warp sums; the gradients equal an uncounted
    launch's within the atomics' reordering."""
    scene, cam = make(cuda)
    x, y = _pixel_grid(64, 64, cuda)
    ray = cam.primary_rays(x, y, 64, 64)
    o, d = ray.ori.contiguous(), ray.dir.contiguous()
    bg = torch.tensor(BG, device=cuda)
    vols = scene.volumes
    steps = torch.zeros(o.shape[0], dtype=torch.int32, device=cuda)
    color, _, _, dst = tvol._launch(o, d, vols, bg, 1.0, save_dst=True)
    tvol._launch(o, d, vols, bg, 1.0, steps=steps)
    gcolor = torch.tensor(np.random.default_rng(8).uniform(
        -1.0, 1.0, (o.shape[0], 4)).astype(np.float32), device=cuda)
    counts = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = tvol.march_backward(o, d, vols, bg, dst, gcolor,
                              wanted=("texels", "transfer"), counts=counts)
    ref = tvol.march_backward(o, d, vols, bg, dst, gcolor,
                              wanted=("texels", "transfer"))
    torch.cuda.synchronize()
    adds, n_steps = int(counts), int(steps.sum())
    assert 0 < adds <= 8 * n_steps
    for k in ("texels", "transfer"):
        assert _rel(got[k], ref[k]) <= 1e-6
