"""The port's CLI (visionaray_torch/cli.py, the port of render.py) on the
CPU (``--cpu``), at 24x16:

- ``builtin:tri_sphere_plane`` (simple) and ``builtin:volume`` (volume):
  the written file equals the port's ``render`` followed by
  ``io.image.save_png``, byte for byte;
- ``--dump-bvh`` prints its JSON stats line and writes the outline;
  ``--benchmark`` prints its Mrays/s line;
- an OBJ scene, a camera file, ``--camera-matrix``, ``--bvh cluster``
  and ``--bvh sah``, ``--pixel-format RGBA8`` over frames (the typed
  target's blend), ``--elastic`` with a checkpoint (the elastic frame's
  report printed, and a rerun resumes every batch and writes the same
  image);
- without ``--cpu`` and without a GPU the CLI raises (no fallback).
"""

import json

import numpy as np
import pytest
import torch

from visionaray_torch import cli, scenes
from visionaray_torch.io import camera_io
from visionaray_torch.io.image import load_image, save_png
from visionaray_torch.io.obj import load_obj_scene, save_obj
from visionaray_torch.io.pixel_format import make_typed_render_target
from visionaray_torch.sched.render import render

torch.set_num_threads(1)
W, H = 24, 16
CPU = "cpu"


def _run(capsys, *argv):
    assert cli.main(["--cpu", "--width", str(W), "--height", str(H),
                     *argv]) == 0
    return capsys.readouterr().out.splitlines()


def _json_lines(lines):
    return [json.loads(s) for s in lines if s.startswith("{")]


@pytest.mark.parametrize("scene,algo,make", [
    ("builtin:tri_sphere_plane", "simple",
     lambda: scenes.tri_sphere_plane(device=CPU)),
    ("builtin:volume", "volume", lambda: scenes.volume_scene(device=CPU))],
    ids=["simple", "volume"])
def test_cli_image_equals_render(tmp_path, capsys, scene, algo, make):
    out = tmp_path / "cli.png"
    lines = _run(capsys, "--scene", scene, "--algorithm", algo, "-o",
                 str(out))
    written = lines[-1].rsplit("-> ", 1)[1]
    assert lines[-1].startswith(f"rendered {W}x{H} {algo}")
    s, cam = make()
    rt = render(s, cam, W, H, algo=algo)
    ref = save_png(str(tmp_path / "ref.png"), rt.color[..., :3])
    assert written.rsplit(".", 1)[1] == ref.rsplit(".", 1)[1]
    with open(written, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_dump_bvh_and_benchmark_lines(tmp_path, capsys):
    lines = _run(capsys, "--scene", "builtin:teapot", "--dump-bvh",
                 str(tmp_path / "bvh.png"))
    (stats,) = _json_lines(lines)
    assert stats["bvh_dump"].startswith(str(tmp_path / "bvh."))
    assert stats["nodes"] == 2 * stats["leaves"] - 1 > 1
    assert stats["max_depth"] > 0 and stats["sah_cost"] > 0
    lines = _run(capsys, "--scene", "builtin:tri_sphere_plane",
                 "--benchmark", "-o", str(tmp_path / "b.png"))
    (bench,) = _json_lines(lines)
    assert bench["metric"] == "Mrays/s" and bench["value"] > 0
    assert bench["frame_ms"] > 0 and bench["device"] == "cpu"


def test_obj_scene_camera_file_and_trees(tmp_path, capsys):
    s, cam = scenes.teapot_scene(detail=8, build_bvh=False, device=CPU)
    save_obj(str(tmp_path / "teapot.obj"), s.mesh)
    camera_io.save_camera(str(tmp_path / "view.cam"), cam)
    imgs = {}
    for extra in ([], ["--camera-matrix"], ["--bvh", "cluster"],
                  ["--bvh", "sah"]):
        lines = _run(capsys, "--scene", str(tmp_path / "teapot.obj"),
                     "--camera", str(tmp_path / "view.cam"), "-o",
                     str(tmp_path / "o.png"), *extra)
        imgs[" ".join(extra)] = load_image(lines[-1].rsplit("-> ", 1)[1])
    # the default: the OBJ's LBVH and the camera file, as in-process
    obj_scene = load_obj_scene(str(tmp_path / "teapot.obj"), device=CPU)
    ref = render(obj_scene, camera_io.load_camera(
        str(tmp_path / "view.cam"), device=CPU), W, H)
    save_png(str(tmp_path / "ref.png"), ref.color[..., :3])
    ref_img = load_image(str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(imgs[""], ref_img)
    assert ref_img[..., :3].std() > 0
    # the other trees and the matrix camera see the same teapot: at most
    # a few edge pixels differ
    for key, img in imgs.items():
        off = (np.abs(img - ref_img).max(-1) > 1 / 255).mean()
        assert off <= 0.02, (key, off)


def test_typed_target_over_frames(tmp_path, capsys):
    lines = _run(capsys, "--scene", "builtin:tri_sphere_plane",
                 "--pixel-format", "RGBA8", "--frames", "2", "-o",
                 str(tmp_path / "typed.png"))
    written = lines[-1].rsplit("-> ", 1)[1]
    s, cam = scenes.tri_sphere_plane(device=CPU)
    rt = make_typed_render_target(W, H, "RGBA8", device=CPU)
    for frame in (1, 2):
        rt = render(s, cam, W, H, frame_num=frame, rt=rt)
    ref = save_png(str(tmp_path / "ref.png"), rt.as_float()[..., :3])
    assert open(written, "rb").read() == open(ref, "rb").read()
    with pytest.raises(SystemExit):
        cli.main(["--cpu", "--scene", "builtin:tri_sphere_plane",
                  "--pixel-format", "RGBA9"])


def test_elastic_with_checkpoint_resumes(tmp_path, capsys):
    argv = ("--scene", "builtin:cornell", "--algorithm", "pathtracing",
            "--bounces", "2", "--elastic", "--elastic-batch", "128",
            "--elastic-checkpoint", str(tmp_path / "ck"))
    first = _run(capsys, *argv, "-o", str(tmp_path / "a.png"))
    (rep,) = _json_lines(first)
    assert rep["elastic_frame"] == 1 and rep["failed"] == 0
    assert rep["completed"] == rep["batches"] == W * H // 128
    again = _run(capsys, *argv, "-o", str(tmp_path / "b.png"))
    (rep2,) = _json_lines(again)
    assert rep2["resumed"] == rep2["batches"] and rep2["completed"] == 0
    a = open(first[-1].rsplit("-> ", 1)[1], "rb").read()
    b = open(again[-1].rsplit("-> ", 1)[1], "rb").read()
    assert a == b


def test_cli_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene", "builtin:tri_sphere_plane", "-o",
                  str(tmp_path / "x.png")])
