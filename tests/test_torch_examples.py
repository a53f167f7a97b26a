"""Run every examples/torch_*.py in a subprocess on the CPU (``--device
cpu``), as tests/test_examples.py runs the JAX package's examples: each
must exit 0 and write its image; the silhouette optimization's loss must
drop below half its first value (the boundary term moves the
silhouette); the inverse-rendering and sharded-render examples start
their own gloo ranks (``--devices 2``), and the inverse-rendering run is
resumed from its checkpoint."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_example(tmp_path, name, *args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name),
         "--device", "cpu", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, (
        f"{name} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout


@pytest.mark.parametrize("name,image", [
    ("torch_minimal.py", "minimal.png"),
    ("torch_intersector_example.py", "intersector.png"),
    ("torch_multi_hit_example.py", "multi_hit.png")])
def test_example_writes_its_image(tmp_path, name, image):
    out = _run_example(tmp_path, name)
    assert image in out
    assert (tmp_path / image).exists()


def test_inverse_rendering_on_two_ranks_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    out = _run_example(tmp_path, "torch_inverse_rendering.py",
                       "--steps", "2", "--size", "8", "--bounces", "2",
                       "--devices", "2", "--checkpoint", ckpt)
    assert "loss" in out and "step" in out, out
    assert os.path.exists(ckpt)
    out = _run_example(tmp_path, "torch_inverse_rendering.py",
                       "--steps", "3", "--size", "8", "--bounces", "2",
                       "--checkpoint", ckpt, "--resume")
    assert "resumed at step 2" in out, out


def test_silhouette_optimization(tmp_path):
    out = _run_example(tmp_path, "torch_silhouette_optimization.py",
                       "--steps", "25", "--size", "32")
    assert (tmp_path / "silhouette_after.png").exists()
    # the loss must actually drop (the boundary term moves the silhouette)
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    first = float(lines[0].split("loss")[1].split()[0])
    last = float(lines[-1].split("loss")[1].split()[0])
    assert last < 0.5 * first, out


def test_sharded_render(tmp_path):
    out = _run_example(tmp_path, "torch_sharded_render.py", "--devices",
                       "2")
    assert "over 2 devices" in out
    assert "wrote sharded_render.png" in out
    assert (tmp_path / "sharded_render.png").exists()
