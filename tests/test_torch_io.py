"""The port's I/O (visionaray_torch/core/norm.py, io/image.py, io/obj.py,
io/camera_io.py) against the JAX package's on the CPU.

- ``core/norm.py``: unorm/snorm round trips equal to JAX's, bit for bit;
- ``io/image.py``: every writer (PNG, PPM, PGM, TGA, HDR) writes the same
  bytes as JAX's on the same array, and every reader gives the same
  array; without Pillow ``save_png`` writes and returns a ``.ppm``, as
  JAX's does;
- ``io/obj.py``: ``parse_mtl``, ``load_obj`` (fan triangulation, negative
  indices, per-corner normals and UVs, usemtl ids, emissive materials) on
  small files written in ``tmp_path``, array-equal to JAX's (the face
  normals the mesh derives to 2.5e-7: the normalization rounds
  differently in the last bit);
  ``load_obj_scene``'s LBVH equal to JAX's, array for array, and a map_Kd
  texture packed alike; ``save_obj`` round trips;
- ``io/camera_io.py``: a camera saved by either package loads equal in
  the other.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from visionaray_tpu.core import norm as jnorm
from visionaray_tpu.core.camera import Pinhole as JPinhole
from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.io import camera_io as jcam_io
from visionaray_tpu.io import image as jimage
from visionaray_tpu.io import obj as jobj

from visionaray_torch.core import norm as tnorm
from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.io import camera_io as tcam_io
from visionaray_torch.io import image as timage
from visionaray_torch.io import obj as tobj

torch.set_num_threads(1)
CPU = "cpu"
NORMAL_ATOL = 2.5e-7

MTL = """# materials
newmtl red
Ka 0.1 0.0 0.0
Kd 0.9 0.1 0.1
Ks 0.3 0.3 0.3
Ns 20
newmtl lamp
Ke 4 4 3.5
newmtl wood
Kd 0.6 0.4 0.2
map_Kd wood.ppm
"""

OBJ = """mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 1 0
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl lamp
f -5/-4/-2 -3/-2/-2 -1/-1/-1
usemtl wood
f 1/1/1 2/2/2 5/3/1
usemtl missing
f 2/2/1 3/3/1 5/4/1
"""

# the same mesh without normals or UVs on every face (per-face binding)
OBJ_PARTIAL = """v 0 0 0
v 2 0 0
v 2 2 0
v 0 2 1
vn 0 0 1
f 1 2 3 4
f 1//1 3//1 4//1
"""


def _arrays(o):
    return {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _image(seed=0, shape=(5, 7, 4), lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("bits", [8, 16, 32])
def test_norm_round_trips_match_jax(bits):
    f = np.random.default_rng(bits).uniform(-1.5, 1.5, 1000)
    f = np.concatenate([f, [0.0, 1.0, -1.0, 0.5, -0.5]])
    for enc, dec in (("float_to_unorm", "unorm_to_float"),
                     ("float_to_snorm", "snorm_to_float")):
        jq = getattr(jnorm, enc)(f, bits)
        tq = getattr(tnorm, enc)(f, bits)
        assert tq.dtype == jq.dtype and np.array_equal(tq, jq)
        np.testing.assert_array_equal(getattr(tnorm, dec)(tq, bits),
                                      getattr(jnorm, dec)(jq, bits))


WRITERS = {"png": "save_png", "ppm": "save_ppm", "pgm": "save_pgm",
           "tga": "save_tga", "hdr": "save_hdr"}


@pytest.mark.parametrize("ext", list(WRITERS))
def test_image_writers_and_readers_match_jax(ext, tmp_path):
    pytest.importorskip("PIL") if ext == "png" else None
    img = _image(1, lo=0.0, hi=4.0 if ext == "hdr" else 1.0)
    jpath, tpath = tmp_path / f"j.{ext}", tmp_path / f"t.{ext}"
    args = () if ext == "hdr" else (True,)
    jw = getattr(jimage, WRITERS[ext])(str(jpath), img, *args)
    tw = getattr(timage, WRITERS[ext])(str(tpath), img, *args)
    assert str(jw) == str(jpath) and str(tw) == str(tpath)
    assert tpath.read_bytes() == jpath.read_bytes()
    # the tensor form writes the same bytes
    again = tmp_path / f"again.{ext}"
    getattr(timage, WRITERS[ext])(str(again), torch.as_tensor(img), *args)
    assert again.read_bytes() == jpath.read_bytes()
    np.testing.assert_array_equal(timage.load_image(str(tpath)),
                                  jimage.load_image(str(jpath)))
    assert timage.save_image(str(tmp_path / f"s.{ext}"), img) is not None


def test_save_png_without_pillow_writes_ppm(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = _image(2)
    got = timage.save_png(str(tmp_path / "t.png"), img)
    ref = jimage.save_png(str(tmp_path / "j.png"), img)
    assert got == str(tmp_path / "t.ppm") and ref == str(tmp_path / "j.ppm")
    assert (tmp_path / "t.ppm").read_bytes() == \
        (tmp_path / "j.ppm").read_bytes()
    assert not (tmp_path / "t.png").exists()


def test_srgb_helpers_match_jax():
    x = _image(3, lo=-0.2, hi=1.2)
    np.testing.assert_array_equal(timage.linear_to_srgb(x),
                                  jimage.linear_to_srgb(x))
    np.testing.assert_array_equal(timage.srgb_to_linear(x),
                                  jimage.srgb_to_linear(x))
    np.testing.assert_array_equal(timage.to_uint8(x, False),
                                  jimage.to_uint8(x, False))


@pytest.fixture()
def obj_dir(tmp_path):
    (tmp_path / "scene.mtl").write_text(MTL)
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "partial.obj").write_text(OBJ_PARTIAL)
    tex = _image(4, shape=(6, 5, 4))
    jimage.save_ppm(str(tmp_path / "wood.ppm"), tex)
    return tmp_path


def test_parse_mtl_matches_jax(obj_dir):
    path = str(obj_dir / "scene.mtl")
    assert tobj.parse_mtl(path) == jobj.parse_mtl(path)
    assert tobj.parse_mtl(str(obj_dir / "none.mtl")) == {}


def _same_mesh_and_materials(t, j):
    tm, tmat, tnames = t
    jm, jmat, jnames = j
    assert tnames == jnames
    derived = {"normals"} | ({"corner_normals"} if jm.face_normals_binding
                             else set())
    for name, v in _arrays(jm).items():
        tv = getattr(tm, name)
        if isinstance(v, bool):
            assert tv == v, name
        elif name in derived:
            # face normals the mesh derives: XLA's normalize and PyTorch's
            # round differently in the last bit (2 ulp at 1 seen)
            np.testing.assert_allclose(_np(tv), np.asarray(v), rtol=0,
                                       atol=NORMAL_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(_np(tv), np.asarray(v),
                                          err_msg=name)
    for name, v in _arrays(jmat).items():
        np.testing.assert_array_equal(_np(getattr(tmat, name)),
                                      np.asarray(v), err_msg=name)


@pytest.mark.parametrize("name", ["scene.obj", "partial.obj"])
def test_load_obj_matches_jax(obj_dir, name):
    path = str(obj_dir / name)
    t = tobj.load_obj(path, device=CPU)
    _same_mesh_and_materials(t, jobj.load_obj(path))
    if name == "scene.obj":
        # fan triangulation: the quad gives two faces; four usemtl ids
        assert t[0].geom_ids.tolist() == [0, 0, 1, 2, 3]
        assert not t[0].face_normals_binding
        assert t[2][2].endswith("wood.ppm") and t[2][0] is None


def test_load_obj_scene_matches_jax(obj_dir):
    path = str(obj_dir / "scene.obj")
    ts = tobj.load_obj_scene(path, texture_resolution=8, device=CPU)
    js = jobj.load_obj_scene(path, texture_resolution=8)
    for f in ("node_lo", "node_hi", "left", "right", "parent", "prim_ids"):
        a, b = np.asarray(getattr(js.bvh, f)), getattr(ts.bvh, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    np.testing.assert_array_equal(ts.textures.texels.numpy(),
                                  np.asarray(js.textures.texels))
    np.testing.assert_array_equal(ts.textures.enabled.numpy(),
                                  np.asarray(js.textures.enabled))
    assert ts.lights.num_lights == 0 and ts.device == torch.device(CPU)
    nobvh = tobj.load_obj_scene(path, build_bvh=False, device=CPU)
    assert nobvh.bvh is None


def test_save_obj_round_trips(tmp_path):
    rng = np.random.default_rng(6)
    verts = rng.uniform(-2, 2, (9, 3)).astype(np.float32)
    faces = np.stack([rng.permutation(9)[:3] for _ in range(11)]).astype(
        np.int32)
    tobj.save_obj(str(tmp_path / "t.obj"),
                  TriangleMesh.create(verts, faces, device=CPU))
    jobj.save_obj(str(tmp_path / "j.obj"), JMesh.create(verts, faces))
    t = tobj.load_obj(str(tmp_path / "t.obj"), device=CPU)
    _same_mesh_and_materials(t, jobj.load_obj(str(tmp_path / "j.obj")))
    np.testing.assert_array_equal(t[0].vertices.numpy(), verts)
    np.testing.assert_array_equal(t[0].faces.numpy(), faces)
    # the same lines as JAX's, under the package's own header
    assert (tmp_path / "t.obj").read_text().splitlines()[1:] == \
        (tmp_path / "j.obj").read_text().splitlines()[1:]


def test_camera_files_cross_load(tmp_path):
    kw = dict(eye=(1.5, 2.0, -3.25), center=(0.1, 0.2, 0.3),
              up=(0.0, 1.0, 0.0), fovy=0.7, aspect=1.6, z_near=0.01,
              z_far=500.0)
    tcam_io.save_camera(str(tmp_path / "t.cam"),
                        Pinhole.create(**kw, device=CPU))
    jcam_io.save_camera(str(tmp_path / "j.cam"), JPinhole.create(**kw))
    assert (tmp_path / "t.cam").read_text() == \
        (tmp_path / "j.cam").read_text()
    for path in ("t.cam", "j.cam"):
        t = tcam_io.load_camera(str(tmp_path / path), device=CPU)
        j = jcam_io.load_camera(str(tmp_path / path))
        for f in ("eye", "center", "up", "fovy", "aspect", "z_near",
                  "z_far"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    (tmp_path / "bad.cam").write_text("1 2 3")
    with pytest.raises(ValueError, match="camera"):
        tcam_io.load_camera(str(tmp_path / "bad.cam"), device=CPU)
