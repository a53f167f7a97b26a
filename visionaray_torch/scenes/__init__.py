"""Procedurally generated built-in scenes (port of visionaray_tpu/scenes/):
the same geometry, made with numpy on the host and placed on ``device``."""

from visionaray_torch.scenes.basic import (
    cornell_box, cornell_box_spectral, random_triangles, tri_sphere_plane,
)
from visionaray_torch.scenes.instanced import (
    grid_transforms, instance_mesh, sponza_x16_scene,
)
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.scenes.teapot import teapot_mesh, teapot_scene
from visionaray_torch.scenes.volume_demo import (
    multi_volume_scene, volume_scene,
)

__all__ = [
    "tri_sphere_plane", "cornell_box", "cornell_box_spectral",
    "random_triangles", "teapot_scene", "teapot_mesh",
    "sponza_like_scene", "volume_scene", "multi_volume_scene",
    "grid_transforms", "instance_mesh", "sponza_x16_scene",
]
