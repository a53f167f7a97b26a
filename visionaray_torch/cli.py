"""CLI renderer of the port (port of render.py, flag for flag; the headless
analogue of vsnray-viewer, src/viewer/viewer.cpp).

    python -m visionaray_torch.cli --scene builtin:tri_sphere_plane \\
        --algorithm simple --width 256 --height 256 --output out.png
    python -m visionaray_torch.cli --scene scene.obj --algorithm \\
        pathtracing --spp 16 --bounces 10 --output out.png
    python -m visionaray_torch.cli --scene builtin:sponza --bvh cluster \\
        --algorithm pathtracing --nee --width 1920 --height 1080

It renders on the CUDA device, and raises without one; ``--cpu`` renders
on the CPU with the plain PyTorch versions of the kernels.  Beyond
render.py's flags, ``--pixel-format FMT`` accumulates the frames into a
quantized TypedRenderTarget (io/pixel_format.py) instead of a float one.
The image is written by io/image.py's ``save_image`` (a PPM in place of a
PNG where Pillow is absent: the line printed names the file written).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def build_scene(name: str, args, device):
    """(scene, camera or None) for ``--scene``: a built-in scene or an OBJ
    file (render.py's build_scene)."""
    from visionaray_torch import scenes
    if name.startswith("builtin:"):
        key = name.split(":", 1)[1]
        if key in ("tri_sphere_plane", "config1"):
            return scenes.tri_sphere_plane(device=device)
        if key in ("cornell", "cornell_box"):
            return scenes.cornell_box(device=device)
        if key == "cornell_spectral":
            return scenes.cornell_box_spectral(device=device)
        if key == "teapot":
            return scenes.teapot_scene(build_bvh=not args.no_bvh,
                                       device=device)
        if key in ("sponza_x16", "config5"):
            return scenes.sponza_x16_scene(
                target_tris_per_instance=args.target_tris, device=device)
        if key.startswith("sponza"):
            return scenes.sponza_like_scene(target_tris=args.target_tris,
                                            build_bvh=not args.no_bvh,
                                            device=device)
        if key == "volume":
            return scenes.volume_scene(device=device)
        if key == "multi_volume":
            return scenes.multi_volume_scene(device=device)
        raise SystemExit(f"unknown builtin scene: {key}")
    from visionaray_torch.io.obj import load_obj_scene
    return load_obj_scene(name, build_bvh=not args.no_bvh,
                          device=device), None


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m visionaray_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", required=True,
                   help="OBJ path or builtin:{tri_sphere_plane,cornell,"
                        "cornell_spectral,teapot,sponza,volume,"
                        "multi_volume,sponza_x16}")
    p.add_argument("--algorithm", default="simple",
                   choices=["simple", "whitted", "pathtracing", "ao",
                            "volume"])
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--frames", type=int, default=1,
                   help="progressive accumulation frames (pathtracing)")
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--ambient", type=float, nargs=3, default=None)
    p.add_argument("--camera", default=None, help="camera file to load")
    p.add_argument("--camera-matrix", action="store_true",
                   help="primary rays through the inverse view-proj matrix "
                        "(MatrixCamera, the reference's "
                        "sched_common.h:152-178) instead of the pinhole "
                        "basis")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--center", type=float, nargs=3, default=None)
    p.add_argument("--fovy", type=float, default=45.0, help="degrees")
    p.add_argument("--output", "-o", default="out.png")
    p.add_argument("--no-srgb", action="store_true")
    p.add_argument("--no-bvh", action="store_true")
    p.add_argument("--bvh", choices=["lbvh", "cluster", "sah", "sbvh"],
                   default="lbvh",
                   help="acceleration structure: lbvh (built on the "
                        "device), cluster (ClusterBVH), or the host "
                        "quality builders sah / sbvh (binned SAH, sbvh "
                        "adds spatial splits; native/sah_builder.cpp)")
    p.add_argument("--treelet", type=int, default=-1,
                   help="ClusterBVH treelet size for binned incoherent-ray "
                        "traversal (-1 = auto: 128 for pathtracing, off "
                        "otherwise; 0 = off)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation for pathtracing")
    p.add_argument("--spectral", type=int, default=0, metavar="N",
                   help="spectral pathtracing with N wavelength samples "
                        "(0 = RGB mode)")
    p.add_argument("--tile-size", type=int, default=0)
    p.add_argument("--target-tris", type=int, default=260_000)
    p.add_argument("--benchmark", action="store_true",
                   help="print Mrays/s metrics as JSON")
    p.add_argument("--dump-bvh", default=None, metavar="PNG",
                   help="write a level-colored AABB-outline rendering of "
                        "the built BVH + a stats line, then exit")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the plain PyTorch versions of "
                        "the kernels); without it the CUDA device, or an "
                        "error")
    p.add_argument("--pixel-format", default=None, metavar="FMT",
                   help="accumulate into a quantized TypedRenderTarget of "
                        "this format (io/pixel_format.py, e.g. RGBA8)")
    p.add_argument("--elastic", action="store_true",
                   help="elastic scheduler: per-batch re-dispatch on "
                        "failure + npz checkpoint/resume "
                        "(sched/elastic.py)")
    p.add_argument("--elastic-batch", type=int, default=1 << 16,
                   help="pixels per elastic batch")
    p.add_argument("--elastic-checkpoint", default=None, metavar="PATH",
                   help="npz checkpoint for elastic resume (preemption "
                        "loses at most one checkpoint window)")
    return p


def _camera(args, scene, cam, device):
    from visionaray_torch.core.camera import MatrixCamera, Pinhole
    if cam is None or args.eye is not None or args.camera is not None:
        if args.camera:
            from visionaray_torch.io.camera_io import load_camera
            cam = load_camera(args.camera, device=device)
        else:
            bbox = scene.bbox()
            cam0 = Pinhole.create(eye=(0, 0, 1), center=(0, 0, 0),
                                  fovy=np.deg2rad(args.fovy),
                                  aspect=args.width / args.height,
                                  device=device)
            if args.eye is not None:
                center = args.center or bbox.center().tolist()
                cam = cam0.look_at(args.eye, center)
            else:
                cam = cam0.view_all(bbox.lo, bbox.hi)
    if args.camera_matrix:
        cam = MatrixCamera.from_pinhole(cam)
    return cam


def elastic_params(scene, algorithm: str, bounces=None, ambient=None):
    """(KernelParams, pixel sampler) of the elastic frame: render's
    defaults for ``algorithm`` (algo_defaults, the epsilon from the scene
    diagonal, the default background) unless given."""
    from visionaray_torch.kernels.params import KernelParams
    from visionaray_torch.sched.render import algo_defaults

    d_bounces, d_ambient, sampler = algo_defaults(algorithm)
    bbox = scene.bbox()
    eps = max(1e-3, float(torch.linalg.norm(bbox.hi - bbox.lo)) * 1e-5)
    params = KernelParams.create(
        scene, num_bounces=bounces or d_bounces, epsilon=eps,
        bg_color=(0.1, 0.4, 1.0, 1.0), ambient_color=ambient or d_ambient)
    return params, sampler


def _elastic(args, scene, cam, ambient):
    """render.py's elastic path: each frame through render_frame_elastic,
    blended progressively on the host; prints each frame's report."""
    from visionaray_torch.sched.elastic import render_frame_elastic
    from visionaray_torch.sched.render import RenderTarget

    params, sampler = elastic_params(scene, args.algorithm, args.bounces,
                                     ambient)
    acc = None
    for frame in range(1, args.frames + 1):
        ck = (f"{args.elastic_checkpoint}.f{frame}.npz"
              if args.elastic_checkpoint else None)
        img, report = render_frame_elastic(
            params, cam, args.width, args.height, algo=args.algorithm,
            spp=args.spp, pixel_sampler=sampler, frame_num=frame,
            nee=args.nee, batch=args.elastic_batch, checkpoint_path=ck)
        print(json.dumps({"elastic_frame": frame,
                          **dataclasses.asdict(report)}))
        if not report.ok:
            print(f"elastic: frame {frame} had {report.failed} "
                  f"abandoned batches")
        alpha = 1.0 / frame
        acc = img if acc is None else acc * (1 - alpha) + img * alpha
    dev = scene.device
    return RenderTarget(color=torch.as_tensor(acc, device=dev),
                        depth=torch.zeros(acc.shape[:2], device=dev),
                        width=args.width, height=args.height)


def _frames(args, scene, cam, ambient, rt=None, frames=None):
    from visionaray_torch.sched.render import render
    for frame in range(1, (frames or args.frames) + 1):
        rt = render(scene, cam, args.width, args.height,
                    algo=args.algorithm, spp=args.spp, bounces=args.bounces,
                    ambient=ambient, frame_num=frame,
                    tile_size=args.tile_size, rt=rt, nee=args.nee,
                    spectral=args.spectral)
    return rt


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)

    from visionaray_torch.device import resolve_device
    from visionaray_torch.io.image import save_png
    from visionaray_torch.io.pixel_format import (
        PIXEL_FORMATS, make_typed_render_target,
    )

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.pixel_format and args.pixel_format not in PIXEL_FORMATS:
        p.error(f"--pixel-format {args.pixel_format}: not one of "
                f"{', '.join(PIXEL_FORMATS)}")
    scene, cam = build_scene(args.scene, args, device)
    if args.bvh in ("sah", "sbvh") and scene.mesh is not None \
            and not args.no_bvh:
        from visionaray_torch.ops import sah
        if not sah.available():
            p.error("--bvh %s needs the native builder "
                    "(native/sah_builder.cpp; compiled at first use, with "
                    "g++ on PATH)" % args.bvh)
        scene = dataclasses.replace(
            scene, bvh=sah.build(scene.mesh, builder=args.bvh))
    if args.bvh == "cluster" and scene.mesh is not None and not args.no_bvh:
        from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
        # treelets enable binned traversal of incoherent bounce rays, the
        # path tracer's fast path (T=128)
        tsize = args.treelet if args.treelet >= 0 else (
            128 if args.algorithm == "pathtracing" else 0)
        scene = dataclasses.replace(
            scene, bvh=build_cluster_bvh(scene.mesh, treelet_size=tsize))
    cam = _camera(args, scene, cam, device)

    if args.dump_bvh:
        from visionaray_torch.utils.bvh_debug import dump_bvh
        tgt = scene.bvh if scene.bvh is not None else scene.sphere_bvh
        if tgt is None:
            p.error("--dump-bvh: the scene has no BVH "
                    "(drop --no-bvh or pick --bvh)")
        stats = dump_bvh(tgt, args.dump_bvh, width=args.width)
        print(json.dumps({"bvh_dump": stats.pop("path"), **stats}))
        return 0

    ambient = tuple(args.ambient) + (1.0,) if args.ambient else None
    typed = (make_typed_render_target(args.width, args.height,
                                      args.pixel_format, device=device)
             if args.pixel_format else None)
    _sync(device)
    t_start = time.perf_counter()
    if args.elastic:
        rt = _elastic(args, scene, cam, ambient)
    else:
        rt = _frames(args, scene, cam, ambient, rt=typed)
    color = rt.as_float() if args.pixel_format else rt.color
    _sync(device)
    elapsed = time.perf_counter() - t_start

    written = save_png(args.output, color[..., :3], srgb=not args.no_srgb)
    n_prims = scene.num_triangles + scene.num_spheres + scene.num_planes
    print(f"rendered {args.width}x{args.height} {args.algorithm} "
          f"({n_prims} prims, {args.spp} spp x {args.frames} frames) "
          f"in {elapsed:.2f}s -> {written}")

    if args.benchmark:
        # timed again, after the first frames' kernel builds
        reps = 3
        _sync(device)
        t0 = time.perf_counter()
        _frames(args, scene, cam, ambient, rt=typed, frames=reps)
        _sync(device)
        dt = (time.perf_counter() - t0) / reps
        bounces = args.bounces or (10 if args.algorithm == "pathtracing"
                                   else 4)
        rays_per_frame = args.width * args.height * args.spp * (
            1 if args.algorithm == "simple" else bounces)
        print(json.dumps({
            "metric": "Mrays/s",
            "value": rays_per_frame / dt / 1e6,
            "frame_ms": dt * 1e3,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
