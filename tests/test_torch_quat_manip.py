"""The viewer's camera: core/quat.py and io/manip.py of the port against
the JAX package's (tests/test_manip.py's ten cases, each run on both
packages and compared, and each of the thirteen quaternion functions
against JAX's on the same numpy inputs, within 1e-6 absolute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core import quat as jq
from visionaray_tpu.core.camera import Pinhole as JPinhole
from visionaray_tpu.io import manip as jmanip

from visionaray_torch.core import quat as tq
from visionaray_torch.core.camera import Pinhole
from visionaray_torch.io import manip as tmanip

torch.set_num_threads(1)
ATOL = 1e-6
RNG = np.random.default_rng(9)
Q = RNG.normal(size=(5, 4)).astype(np.float32)
Q /= np.linalg.norm(Q, axis=-1, keepdims=True)
P = RNG.normal(size=(5, 4)).astype(np.float32)
V = RNG.normal(size=(5, 3)).astype(np.float32)
W = RNG.normal(size=(5, 3)).astype(np.float32)
ANG = RNG.uniform(-3.0, 3.0, 5).astype(np.float32)

# (name, arguments as numpy arrays)
QUAT_CASES = [
    ("quat", (Q[:, 0], Q[:, 1], Q[:, 2], Q[:, 3])),
    ("identity", ()),
    ("from_wxyz", (Q[:, 0], V)),
    ("rotation_from_to", (V, W)),
    ("rotation_axis_angle", (V, ANG)),
    ("mul", (P, Q)),
    ("conjugate", (P,)),
    ("norm", (P,)),
    ("normalize_quat", (P,)),
    ("rotation_angle", (Q,)),
    ("rotation_axis", (Q,)),
    ("to_matrix4", (Q,)),
    ("rotate_vec", (Q, V)),
]


@pytest.mark.parametrize("name,args", QUAT_CASES,
                         ids=[c[0] for c in QUAT_CASES])
def test_quat_function_matches_jax(name, args):
    ref = np.asarray(getattr(jq, name)(*[jnp.asarray(a) for a in args]))
    got = getattr(tq, name)(*[torch.as_tensor(a) for a in args]).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_quat_identity_mul():
    p = tq.rotation_axis_angle(torch.tensor([0.0, 1.0, 0.0]), 0.7)
    torch.testing.assert_close(tq.mul(tq.identity(), p), p, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(tq.mul(p, tq.identity()), p, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(tq.mul(p, tq.conjugate(p)), tq.identity(),
                               atol=1e-6, rtol=0)


def test_quat_axis_angle_roundtrip():
    axis = torch.tensor([1.0, 2.0, -0.5])
    p = tq.rotation_axis_angle(axis, 1.1)
    assert float(tq.norm(p)) == pytest.approx(1.0, abs=1e-6)
    assert float(tq.rotation_angle(p)) == pytest.approx(1.1, abs=1e-5)
    np.testing.assert_allclose(tq.rotation_axis(p).numpy(),
                               (axis / axis.norm()).numpy(), atol=1e-5)


def test_quat_matrix_matches_rotate_vec():
    p = tq.rotation_axis_angle(torch.tensor([0.3, -1.0, 0.2]), 2.1)
    m = tq.to_matrix4(p)
    v = torch.tensor([0.5, -0.25, 2.0])
    np.testing.assert_allclose((m[:3, :3] @ v).numpy(),
                               tq.rotate_vec(p, v).numpy(), atol=1e-5)
    r = m[:3, :3].double().numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(r) == pytest.approx(1.0, abs=1e-5)


def test_quat_rotation_from_to_doubles_angle():
    a = torch.tensor([1.0, 0.0, 0.0])
    b = torch.tensor([0.0, 1.0, 0.0])
    p = tq.rotation_from_to(a, b)
    assert float(tq.rotation_angle(p)) == pytest.approx(np.pi, abs=1e-5)
    np.testing.assert_allclose(tq.rotate_vec(p, a).numpy(), -a.numpy(),
                               atol=1e-5)


def test_arcball_project_inside_and_rim():
    vp = (0, 0, 200, 100)
    for px, py in ((100, 50), (400, 50), (100, 10), (37, 91)):
        np.testing.assert_allclose(
            tmanip.Arcball().project(px, py, vp).numpy(),
            np.asarray(jmanip.Arcball().project(px, py, vp)), atol=ATOL)
    rim = tmanip.Arcball().project(400, 50, vp)
    assert float(rim[2]) == 0.0
    assert float(rim.norm()) == pytest.approx(1.0, abs=1e-6)
    assert float(tmanip.Arcball().project(100, 10, vp)[1]) > 0.0


def _cams():
    kw = dict(eye=(0.0, 0.0, 5.0), center=(0.0, 0.0, 0.0),
              up=(0.0, 1.0, 0.0), fovy=np.pi / 4, aspect=2.0)
    return Pinhole.create(device="cpu", **kw), JPinhole.create(**kw)


def _drive(kind, events):
    """The same mouse events through both packages' manipulator ``kind``;
    returns (port camera, JAX camera)."""
    tcam, jcam = _cams()
    out = []
    for mod, cam in ((tmanip, tcam), (jmanip, jcam)):
        m = getattr(mod, kind)(cam, viewport=(0, 0, 800, 400))
        for ev in events:
            if ev == "up":
                m.handle_mouse_up()
            else:
                getattr(m, f"handle_mouse_{ev[0]}")(*ev[1:])
        out.append(m.camera)
    return out


def _same_camera(t, j):
    for f in ("eye", "center", "up"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), atol=1e-5)


def test_arcball_manipulator_preserves_distance_and_center():
    t, j = _drive("ArcballManipulator",
                  [("down", 400, 200), ("move", 500, 250), "up"])
    _same_camera(t, j)
    np.testing.assert_allclose(t.center.numpy(), [0.0, 0.0, 0.0], atol=1e-6)
    assert float(t.distance) == pytest.approx(5.0, rel=1e-5)
    assert float((t.eye - torch.tensor([0.0, 0.0, 5.0])).norm()) > 0.1


def test_arcball_manipulator_continues_across_drags():
    drag = [("down", 400, 200), ("move", 500, 200), "up"]
    t1, _ = _drive("ArcballManipulator", drag)
    t2, j2 = _drive("ArcballManipulator", drag + drag)
    _same_camera(t2, j2)
    assert not np.allclose(t1.eye.numpy(), t2.eye.numpy())
    assert float(t2.eye.norm()) == pytest.approx(5.0, rel=1e-4)


def test_no_drag_without_mouse_down():
    t, j = _drive("ArcballManipulator", [("move", 500, 250)])
    _same_camera(t, j)
    np.testing.assert_allclose(t.eye.numpy(), [0.0, 0.0, 5.0])


def test_pan_manipulator_moves_eye_and_center_together():
    t, j = _drive("PanManipulator", [("down", 400, 200), ("move", 480, 200)])
    _same_camera(t, j)
    delta_eye = t.eye.numpy() - [0.0, 0.0, 5.0]
    np.testing.assert_allclose(delta_eye, t.center.numpy(), atol=1e-6)
    assert delta_eye[0] == pytest.approx(-80 / 800 * 2.0 * 5.0, rel=1e-4)
    assert delta_eye[1] == pytest.approx(0.0, abs=1e-6)


def test_zoom_manipulator_dollies_along_view_axis():
    t, j = _drive("ZoomManipulator", [("down", 400, 200), ("move", 400, 100)])
    _same_camera(t, j)
    np.testing.assert_allclose(t.eye.numpy(), [0.0, 0.0, 7.5], atol=1e-5)
    np.testing.assert_allclose(t.center.numpy(), [0.0, 0.0, 0.0], atol=1e-6)
