"""The port's elastic scheduler (visionaray_torch/sched/elastic.py), the
mirror of tests/test_elastic.py on the CPU: re-dispatch of failed pixel
batches, fault injection, checkpoint/resume of partial frames; and the
frame against JAX's elastic frame and the port's own whole-frame render.
"""

import numpy as np
import pytest
import torch

from visionaray_tpu.kernels.params import KernelParams as JParams
from visionaray_tpu.scenes import cornell_box as j_cornell
from visionaray_tpu.sched.elastic import render_frame_elastic as j_elastic

from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.scenes import cornell_box
from visionaray_torch.sched.elastic import render_frame_elastic
from visionaray_torch.sched.render import _pixel_grid, render_pixels

torch.set_num_threads(1)
W = H = 32
BATCH = 256   # 4 batches per frame
CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    scene, cam = cornell_box(device=CPU)
    params = KernelParams.create(scene, num_bounces=2, epsilon=1e-3,
                                 bg_color=(0, 0, 0, 1),
                                 ambient_color=(0, 0, 0, 0))
    return params, cam


def _render(params, cam, **kw):
    return render_frame_elastic(params, cam, W, H, algo="pathtracing",
                                spp=1, batch=BATCH, **kw)


def test_clean_run(setup):
    params, cam = setup
    img, rep = _render(params, cam)
    assert rep.ok and rep.completed == rep.batches == (W * H) // BATCH
    assert rep.errors == rep.retried == rep.failed == rep.resumed == 0
    assert np.isfinite(img).all() and img[..., :3].max() > 0


def test_frame_equals_whole_frame_and_jax(setup):
    """The batched frame equals render_pixels over the whole frame bit for
    bit, and JAX's elastic frame to the image tolerance of
    test_torch_simple.py (mean abs <= 1e-4, at most 2% of pixels off by
    more than 1e-3)."""
    params, cam = setup
    img, _ = _render(params, cam)
    x, y = _pixel_grid(W, H, CPU)
    whole, _ = render_pixels(params, cam, x, y, W, H, "pathtracing", 1,
                             "jittered_blend", 1)
    np.testing.assert_array_equal(img, whole.reshape(H, W, 4).numpy())
    js, jcam = j_cornell()
    jparams = JParams.create(js, num_bounces=2, epsilon=1e-3,
                             bg_color=(0, 0, 0, 1),
                             ambient_color=(0, 0, 0, 0))
    ref, jrep = j_elastic(jparams, jcam, W, H, algo="pathtracing", spp=1,
                          batch=BATCH)
    assert jrep.ok
    diff = np.abs(img - ref)
    assert diff.mean() <= 1e-4
    assert (diff.max(-1) > 1e-3).mean() <= 0.02


def test_fault_injection_retries_bit_identical(setup):
    params, cam = setup
    ref, _ = _render(params, cam)

    class Bomb(Exception):
        pass

    def hook(b, attempt):
        if b == 1 and attempt == 0:
            raise Bomb("injected device fault")

    img, rep = _render(params, cam, fault_hook=hook)
    assert rep.ok and rep.errors == 1 and rep.retried == 1
    np.testing.assert_array_equal(img, ref)   # counter RNG: bit-identical


def test_exhausted_retries_reports_failure(setup):
    params, cam = setup

    def hook(b, attempt):
        if b == 2:
            raise RuntimeError("persistent fault")

    img, rep = _render(params, cam, retries=1, fault_hook=hook)
    assert not rep.ok
    assert rep.failed == 1 and rep.completed == rep.batches - 1
    assert rep.errors == 2   # first attempt + one retry
    assert rep.last_error == repr(RuntimeError("persistent fault"))
    assert (img.reshape(-1, 4)[2 * BATCH:3 * BATCH] == 0).all()


def test_checkpoint_resume(setup, tmp_path):
    params, cam = setup
    ref, _ = _render(params, cam)
    ck = str(tmp_path / "frame.npz")

    class Preempt(Exception):
        pass

    # first run: die at batch 2 after checkpointing every completed batch
    def hook(b, attempt):
        if b == 2:
            raise Preempt()

    img1, rep1 = _render(params, cam, retries=0, checkpoint_path=ck,
                         checkpoint_every=1, fault_hook=hook)
    assert rep1.failed >= 1 and rep1.completed >= 2

    # second run resumes: completed batches skipped, result bit-identical
    img2, rep2 = _render(params, cam, checkpoint_path=ck,
                         checkpoint_every=1)
    assert rep2.ok and rep2.resumed >= 2
    assert rep2.completed == rep2.batches - rep2.resumed
    np.testing.assert_array_equal(img2, ref)


def test_checkpoint_mismatch_ignored(setup, tmp_path):
    """A checkpoint from another frame/shape must not be resumed from."""
    params, cam = setup
    ck = str(tmp_path / "frame.npz")
    _render(params, cam, checkpoint_path=ck, frame_num=1)
    img, rep = _render(params, cam, checkpoint_path=ck, frame_num=2)
    assert rep.resumed == 0 and rep.ok


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path):
    """The checkpoint file is the JAX package's: a frame JAX checkpointed
    whole is resumed by the port without rendering a batch."""
    params, cam = setup
    js, jcam = j_cornell()
    jparams = JParams.create(js, num_bounces=2, epsilon=1e-3,
                             bg_color=(0, 0, 0, 1),
                             ambient_color=(0, 0, 0, 0))
    ck = str(tmp_path / "jax.npz")
    ref, _ = j_elastic(jparams, jcam, W, H, algo="pathtracing", spp=1,
                       batch=BATCH, checkpoint_path=ck)
    img, rep = _render(params, cam, checkpoint_path=ck)
    assert rep.ok and rep.resumed == rep.batches and rep.completed == 0
    np.testing.assert_array_equal(img, ref)
