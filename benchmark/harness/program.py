"""The program's objects made from a configuration: the only place, with
the drivers, that imports the system under test (``visionaray_torch``).
Nothing here imports it at module level."""

from __future__ import annotations


def materials(config: dict, dev):
    """The configuration's material table (``materials``: a list of
    {type, fields of the program's constructor of that type})."""
    from visionaray_torch.shading.materials import Materials
    return Materials.concatenate([
        getattr(Materials, m["type"])(
            **{k: v for k, v in m.items() if k != "type"}, device=dev)
        for m in config["materials"]])


def lights(config: dict, dev):
    from visionaray_torch.shading.lights import PointLights
    ls = config["lights"]
    return PointLights.create(
        position=[x["position"] for x in ls], cl=[x["cl"] for x in ls],
        kl=[x["kl"] for x in ls],
        attenuation=[x.get("attenuation", (1.0, 0.0, 0.0)) for x in ls],
        device=dev)


def camera(cam: dict, dev):
    from visionaray_torch.core.camera import Pinhole
    return Pinhole.create(**cam, device=dev)


def mesh(verts, faces, gids, dev):
    from visionaray_torch.core.scene import TriangleMesh
    return TriangleMesh.create(verts, faces, geom_ids=gids, device=dev)


def scene(config: dict, verts, faces, gids, dev):
    """The scene on ``dev`` with the tree the configuration names."""
    from visionaray_torch.core.scene import Scene
    from visionaray_torch.ops.lbvh import build_lbvh
    if config["tree"] != "lbvh":
        raise ValueError(f"tree {config['tree']!r}: this driver runs lbvh")
    m = mesh(verts, faces, gids, dev)
    s = Scene.create(mesh=m, materials=materials(config, dev),
                     lights=lights(config, dev), device=dev)
    s.bvh = build_lbvh(m)
    return s


def kernel_params(config: dict, traffic: dict, scene_):
    from visionaray_torch.kernels.params import KernelParams
    r = config["render"]
    return KernelParams.create(
        scene_, num_bounces=traffic["bounces"], epsilon=r["epsilon"],
        bg_color=tuple(r["bg_color"]), ambient_color=tuple(r["ambient"]))


def counters() -> dict:
    """The program's own counters: walk launches by mode and entry point,
    and the ring's transport."""
    from visionaray_torch.ops import traverse
    from visionaray_torch.parallel import comm
    return dict(launches={k: v for k, v in traverse.LAUNCHES.items() if v},
                entries={k: v for k, v in traverse.ENTRY_LAUNCHES.items()
                         if v},
                transport=dict(comm.STATS))


def reset_counters():
    from visionaray_torch.ops import traverse
    from visionaray_torch.parallel import comm
    traverse.reset_launch_counts()
    comm.reset_stats()


def build_library():
    """Build (or find built) and load the kernels' library; its build
    directory is the program's own, inside the checkout."""
    from visionaray_torch.ops import traverse
    traverse._library()
    return dict(traverse.BUILD_INFO)
