"""The port's native SAH and SBVH builders (visionaray_torch/ops/sah.py)
against the JAX package's (visionaray_tpu/ops/sah.py) on the CPU: both
load ``native/sah_builder.cpp``, so the arrays must be equal; the port
builds its library under ``build/`` (never into ``native/``).  Then the
SBVH's generalized leaves through the LBVH tier: closest and any hits
against JAX's jnp tier on the same tree (t to rtol 1e-6, scaled by the
conditioning as in tests/test_torch_bvh_traversal.py), and ``sah_cost``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visionaray_tpu.core.scene import TriangleMesh as JMesh
from visionaray_tpu.core.types import Ray as JRay
from visionaray_tpu.ops import lbvh as jl
from visionaray_tpu.ops import sah as js
from visionaray_tpu.ops import traversal as jt
from visionaray_tpu.scenes import random_triangles
from visionaray_tpu.scenes import sponza_like_scene as j_sponza

from visionaray_torch.convert import bvh_from_arrays
from visionaray_torch.core.scene import TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.ops import lbvh as tl
from visionaray_torch.ops import sah as ts
from visionaray_torch.ops import traversal as tt

from test_torch_bvh_traversal import _cos, _same_t

torch.set_num_threads(1)
CPU = "cpu"
FIELDS = ("node_lo", "node_hi", "left", "right", "parent", "prim_ids",
          "leaf_first", "leaf_count")


def _soup():
    verts, faces = random_triangles(180, seed=13, extent=4.0, tri_size=1.5)
    return (JMesh.create(verts, faces),
            TriangleMesh.create(verts, faces, device=CPU))


def _sponza():
    jscene, _ = j_sponza(target_tris=1500, build_bvh=False)
    m = jscene.mesh
    return m, TriangleMesh.create(np.array(m.vertices), np.array(m.faces),
                                  device=CPU)


def _same(jb, tb):
    for name in FIELDS:
        a, b = getattr(jb, name), getattr(tb, name)
        if a is None:
            assert b is None, name
            continue
        assert np.array_equal(np.asarray(a), b.numpy()), name
    assert jb.max_leaf_size == tb.max_leaf_size


def test_library_lives_under_build():
    assert ts.available()
    path = ts.library_path()
    assert path.exists() and "build" in path.parts
    assert path.parent.parent.name == "sah"
    assert ts.SOURCE.name == "sah_builder.cpp"
    assert ts.SOURCE.parent.name == "native"


@pytest.mark.parametrize("scene", ["soup", "sponza"])
@pytest.mark.parametrize("builder", ["sah", "sbvh"])
def test_builds_equal_jax(scene, builder):
    jm, tm = _soup() if scene == "soup" else _sponza()
    jb = getattr(js, f"build_{builder}")(jm)
    tb = getattr(ts, f"build_{builder}")(tm)
    _same(jb, tb)
    assert tb.depth == tl.tree_depth(tb.left, tb.right)
    assert tl.sah_cost(tb) == pytest.approx(jl.sah_cost(jb), rel=1e-6)
    if builder == "sah":
        v1, e1, e2 = tm.corners()
        assert all(tl.validate(tb, *tl.triangle_aabbs(v1, e1, e2)).values())
    else:
        assert tb.num_prims >= tb.num_leaves
        assert int(tb.leaf_count.max()) <= tb.max_leaf_size


def test_build_dispatch():
    _, tm = _soup()
    assert ts.build(tm, "lbvh").leaf_first is None
    assert ts.build(tm, "sah").max_leaf_size == 1
    assert ts.build(tm, "sbvh").leaf_first is not None
    with pytest.raises(ValueError, match="builder"):
        ts.build(tm, "kd")


def _rays(n=200, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    d = -o + rng.normal(scale=1.5, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_sbvh_hits_match_jax(mode):
    """Generalized leaves: each visited leaf tests its leaf_count refs;
    refs duplicated by spatial splits give the same primitive."""
    jm, tm = _soup()
    jb = js.build_sbvh(jm)
    tb = bvh_from_arrays({**{f: None if getattr(jb, f) is None
                             else np.asarray(getattr(jb, f))
                             for f in FIELDS},
                          "max_leaf_size": jb.max_leaf_size}, device=CPU)
    o, d = _rays()
    jr, tr = JRay(jnp.asarray(o), jnp.asarray(d)), Ray(torch.tensor(o),
                                                       torch.tensor(d))
    if mode == "closest":
        jhr, thr = jt.bvh_closest_hit(jr, jb, jm), tt.bvh_closest_hit(tr, tb,
                                                                        tm)
    else:
        mt = np.random.default_rng(2).uniform(0.5, 9.0, o.shape[0]).astype(
            np.float32)
        jhr = jt.bvh_any_hit(jr, jb, jm, jnp.asarray(mt))
        thr = tt.bvh_any_hit(tr, tb, tm, torch.tensor(mt))
    hit = np.asarray(jhr.hit)
    np.testing.assert_array_equal(thr.hit.numpy(), hit)
    np.testing.assert_array_equal(thr.prim_id.numpy(), np.asarray(jhr.prim_id))
    _same_t(thr.t.numpy(), np.asarray(jhr.t), hit,
            _cos(jhr.prim_id, d, tm.normals.numpy()))
    assert hit.sum() > 40
    # the walk agrees with the SAH tree's (1:1 leaves) closest hit
    if mode == "closest":
        ref = tt.bvh_closest_hit(tr, ts.build_sah(tm), tm)
        np.testing.assert_array_equal(ref.hit.numpy(), thr.hit.numpy())
        np.testing.assert_array_equal(ref.t.numpy(), thr.t.numpy())
