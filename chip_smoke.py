#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (visionaray_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the nvcc build of ops/cuda/traverse_binned.cu,
   traverse_coherent.cu, traverse_lbvh.cu, volume_march.cu and
   volume_march_bwd.cu, one nvcc each, started together (seconds; ptxas'
   registers, shared memory, stack and spills of the main path's forms).
2. Kernel vs plain version, per traversal mode, on every launch captured
   from the real 1080p frame (sponza-class scene, 259,656 triangles, K=32,
   T=128): coherent closest-hit and any-hit (traverse_coherent.cu), binned
   two-pass closest-hit and any-hit (traverse_binned.cu).  The first, a
   middle and the last launch of each mode are compared on >= 8192 lanes
   each (binned modes: tiles that straddle two treelet segments, the tile
   where live lanes end, then tiles with live lanes); every launch is
   timed, and its counters size its bound; the per-frame sums are reported
   beside the first launch.
3. The slice: ClusterBVH built on the card, then the 1920x1080, 1 spp,
   5-bounce NEE frame in bench.py's 64-px block swizzle; one warm frame,
   then timed frames.  Launch counts (per mode, per kernel form and per C
   entry point) are reset just before the first timed frame and read just
   after it: modes 1 and 1d must have run traverse_coherent.cu.
4. Whole-path check: a small config (sponza_like 4000 triangles, K=8, T=16,
   64x64, 3 bounces, NEE) rendered through the kernel and through the
   plain version, both on the card, compared image to image.
5. The training step (sched/step.py, bench.py's value_and_grad over the
   vertices and the albedo) at full width: the 1080p frame of phase 3 in
   bench.py's one 2^21-lane tile.  One warm step, one step whose forward
   and backward launches are counted apart (the backward must launch no
   traversal) and whose peak memory is read, then timed steps.  The loss
   and both gradients must be finite and the gradients non-zero.
6. Gradient check: phase 4's configuration at 32x32, loss_and_grads
   through the kernel and through the plain version on the card, held to
   the CPU test's tolerance.
7. The radix-tree form (row 1e): build_cluster_bvh(treelet_size=0) of the
   260k scene on the card (auto K=32, C=8,115), tables equal to the CPU
   build; (a) the 1080p frame on it (every bounce from the root of the
   radix tree, on traverse_binned.cu), timed as phase 3, its launches
   per entry point printed; its two modes held against the plain version
   on captured launches as in phase 2.  (b) A mesh of 24 triangles
   (C == 1) rendered at 64x64, and its two modes held the same way.
   (c) The simple frame: render(scene on the radix tree, cam, 1920, 1080)
   with defaults only (the simple kernel, uniform sampler), timed as phase
   3 (simple_frame_s): exactly one radix_closest launch, its image finite
   and more than half of its pixels hit, the launch held against the plain
   version; then the same frame on the radix tree at K=40, whose launch
   runs the kernel's run-time-K form.
8. Row 1f on phase 3's scene and tree (K=32, so the kd build carries half
   boxes): the 1080p frame under TraceConfig(fanout=4), (fanout=8),
   (half_skip=True) and (fanout=4, half_skip=True), timed as phase 3, each
   frame's launches counted per kernel form, its image held to phase 3's
   with phase 4's image tolerance, and its modes 1, 1b, 1c and 1d held
   against the plain version on captured launches as in phase 2 (relaunched
   with the captured form; the coherent 1f forms run traverse_binned.cu).
   Then the full-width training step under (fanout=4, half_skip=True),
   checked and timed as phase 5.
9. The main path's other switches: the 1080p frame with shadow_binned=False
   (NEE shadows of bounces 1.. through coherent any-hit: incoherent lanes
   on traverse_coherent.cu) and with shadow_reversed=False, shadow_m=6,
   dir_bits=3; each finite, not constant, with every expected mode
   launched, and its coherent modes held against the plain version on
   captured launches as in phase 2.
10. The Whitted frame on phase 7a's radix tree: render(scene, cam, 1920,
    1080, algo="whitted") with defaults only (4 bounces, one point light),
    timed as phase 3 (whitted_frame_s): 5 radix_closest and 4 radix_any
    launches, the image finite and mostly hit, both modes held against the
    plain version on captured launches as in phase 2.
11. The AO frame, the same for algo="ao" (ao_frame_s), each frame blended
    into the last one's RenderTarget (the counted frame: frame_num=2): 1
    radix_closest and 8 radix_any launches.
12. The boundary step on the radix tree: build_edge_adjacency of the mesh
    (timed, once), then the vertex gradient of the mean RGB of
    render(..., algo="simple", boundary=adj), timed as phase 5
    (boundary_step_s) with its peak memory and increment, the edge and
    silhouette counts: 3 radix_closest launches (primary, f-, f+) held
    against the plain version; the gradient finite and unlike the step's
    with boundary=None; the boundary image exactly 0.  At 32x32 on phase
    6's configuration the gradient through the kernel is held to the plain
    version's with phase 6's limits.
13. The simple frame through a hit filter rejecting every prim whose id is
    0 mod 7 (filtered_frame_s; its launches are its re-traces, at most
    16), its launches against the plain version; on the primary rays no
    accepted prim is one the filter rejects, and where the unfiltered
    winner is accepted the prim is the same and t bit-equal.  Then
    multi_hit(primary rays, k=16) (multi_hit_s, 16 launches): t sorted
    along k, slot 0 the closest hit, every slot's hit and prim against the
    plain version on COMPARE_LANES lanes, the launches against the plain
    version.

14. The LBVH, the CLI's default tree: sponza_like_scene(260_000) with its
    default build_bvh=True on the card (lbvh_scene_s; lbvh_build_s a
    second build_lbvh timed alone; lbvh_pack_ms the kernel's node and
    primitive records packed from its tables, which every launch on that
    tree reuses; tables equal to the CPU build).  On it, every search runs
    traverse_lbvh.cu, one thread per ray: (a) the simple
    frame, render(scene, cam, 1920, 1080) with defaults only
    (lbvh_simple_frame_s), exactly one lbvh_closest launch; (b) the 5-bounce
    NEE frame of phase 3 (lbvh_frame_s), its launches per mode; (c) the
    full-width training step (lbvh_step_s, peak memory, 0 traversal launches
    in backward, finite non-zero gradients), its forward through the fused
    bounce (5 + 5 shading launches; none in the backward, which launches
    the pair's adjoint kernel once a bounce and recomputes no bounce of the
    torch body); (d) multi_hit(primary rays,
    k=16) (lbvh_multi_hit_s): one lbvh_multi launch, t sorted along k, slot
    0 the simple frame's hit; (e) the simple frame through phase 13's
    prim % 7 filter (lbvh_filtered_frame_s), its re-trace launches; (f) the
    bounce's two shading kernels (bounce_shade.cu) in (b)'s frame, run
    anew with the launch counts reset just before: 5 + 5 launches and 5 + 5
    walks; each launch's outputs held bit for bit to its plain version
    (ops/bounce_shade.py) on the launch's own inputs, then each launch
    timed, its plain version timed and its bound taken from the bytes it
    must move (lane arrays for every lane, the gathers by primitive for
    the lanes whose walk hit); the fused frame held to the torch body
    (kernels/pathtracing.py::_torch_body) on the same rays and draws at
    tests/test_torch_cuda_bounce.py's limit, hit and depth equal; (g) (c)'s
    step again, fused and through the torch body on the same inputs and
    draws: loss and gradients within sponza_lbvh.train's limits of
    ``correct`` (STEP_GAPS), the fused step's backward the adjoint kernel
    once a bounce, no shading kernel in the torch body's.  Every
    walk's
    launch mode (first, middle and last launch) is held against the plain
    version on COMPARE_LANES lanes: hit equal everywhere, t equal on the
    same ref, ref equal where the nearest hit is unique (any-hit: equal);
    every launch is timed and counted (box and primitive tests) for its
    bound.  At 64x64 and 32x32 on sponza_like_scene(4000)'s LBVH, the image
    and the gradient through the kernel are held to the plain version's
    with phase 4's and phase 6's limits.
15. The native builders: build_sah and build_sbvh of the same mesh on the
    host (sah_build_s, sbvh_build_s, each tree's sah_cost beside the
    LBVH's), then the simple frame on each (sah_simple_frame_s,
    sbvh_simple_frame_s); the SBVH's launch runs the generalized-leaf form.
16. The sphere BVH: 65,536 spheres placed from a numpy seed in a 40-unit
    cube, radii log-uniform in [0.01, 0.5] and 1% at 1e-9, over a plane
    and under one point light, sphere_bvh = build_sphere_bvh(spheres);
    render(..., algo="whitted") at 1080p (sphere_frame_s): sphere_closest
    and sphere_any launches, held against the plain version.
17. Textures on phase 14's LBVH scene: per-corner UVs from a planar
    projection of the vertices (numpy, seed 17), one procedural 256^2
    image per material (a checker plus noise) packed by
    TextureAtlas.pack (tex_pack_s), LINEAR filtering, WRAP addressing.
    (a) The simple frame, render's defaults (tex_simple_frame_s): one
    lbvh_closest launch; the textured image differs from the untextured
    one, and an all-white enabled atlas (NEAREST) gives the untextured
    frame bit for bit.  (b) The 5-bounce NEE frame of phase 14b
    (tex_frame_s), its launches per mode.  (c) The simple frame under
    NEAREST, BSPLINE_INTERPOL (its pack with the prefilter timed:
    tex_prefilter_s), CARDINAL_SPLINE, MIRROR and BORDER.  Every launch
    mode of (a) and (b) is held against the plain version as in phase 14.
18. Spectral rendering: (a) cornell_box_spectral() (60 samples) on its
    LBVH, render(algo="pathtracing") at 1080p with render's defaults
    (spectral_cornell_frame_s, its peak memory, 10 lbvh_closest launches
    held against the plain version); to_rgb of 300-sample SPDs on the card
    against the CPU's (the fold, max relative error <= 1e-5).  (b) Phase
    3's frame (treelet ClusterBVH, 5-bounce NEE) with the scene lifted to
    300 samples (spectral_frame_s), rendered in tiles of 524,288 lanes
    (halved while the peak exceeds 40 GB; the tile used is printed), its
    peak memory; modes 1, 1b, 1c and 1d held against the plain version on
    captured launches as in phase 2; the image finite and not black.
19. Volumes: (a) volume_scene(256) (upstream's 256^3 example, 64 MiB of
    texels) and (b) multi_volume_scene(128, 3), each rendered with
    render(..., algo="volume") at 1080p (volume_frame_s,
    multi_volume_frame_s): exactly one vsnray_volume_march launch
    (volume_march.cu, one thread per ray), and in the first frame also
    one vsnray_volume_bricks launch (the march's brick table, built once
    per texels and transfer; held against its plain version,
    kernels/volume.py::brick_table, table and words equal).  The launch
    on the frame's
    primary rays equals the frame; against the plain version on
    COMPARE_LANES lanes of its first, middle and last slice, hit and depth
    equal and colour within 1e-5 (bit-equal or not is printed); its time
    from CUDA events, its steps from the counting form (sizing its
    operations bound: FLOP_STEP a step; at full size equal to every
    earlier design's, VOLUME_STEPS), the steps it skipped in empty
    bricks and its warp-iterations whose every lane skipped, its transfer
    form (VARIANT_LAUNCHES), the time to build its tables
    (volume_pack_ms: padded texels and brick table), registers, stack and
    spills from ptxas, its step loop's SASS instructions (cuobjdump); a
    permuted volume array gives the same image.
20. Volume gradients, on phase 19's two scenes: (a) the backward kernel
    (volume_march_bwd.cu, one launch) against the plain version's
    autograd on the same COMPARE_LANES-lane subsets as phase 19 (the
    three taken together), for the loss sum(color * w) + sum(depth * wd),
    w and wd from a numpy seed, in both of its forms: texels and transfer
    alone (volume_bwd_kernel<false>, the training step's form), then
    every gradient, ray (o, d) and box (lo, hi) ones too (<true>); each
    gradient within relative L2 GRAD_BWD_REL, cosine >= GRAD_BWD_COS, bg
    within BG_BWD_RTOL relative, and only the leaves that require grad
    get one; (b) the
    volume training step at 1080p (volume_step_s, multi_volume_step_s):
    forward and backward of the MSE between render(algo="volume") and a
    target rendered with the transfer scaled by 0.8, over texels and
    transfer, one warm step then TIMED_STEPS timed: launches a step
    (counts reset just before the counted step: the march, its
    backward and the brick table of the step's new texels), peak memory,
    gradients
    finite and non-zero; the backward kernel's time by CUDA events (for
    texels and transfer, for the transfer alone, and for every gradient,
    rays and boxes included), its bound and ptxas' registers, stack and
    spills, and the shared-memory adds its transfer gradient issued
    (transfer_atomics, from the kernel's counting argument, in both
    forms).
21. The port's CLI, ``visionaray_torch.cli.main(argv)`` at 1920x1080,
    each run with its wall seconds, its launches (counts reset just
    before) and its check: (a) builtin:teapot, simple, on its LBVH;
    (b) builtin:sponza --bvh cluster --algorithm pathtracing --nee (the
    main path at 260k triangles on a treelet ClusterBVH: modes 1, 1b, 1c,
    1d); (c) the 260k mesh through save_obj into a temporary directory,
    then the CLI's simple frame of that OBJ (its LBVH) with the sponza
    camera from a camera file: the mesh read back equals the one saved
    and the image equals the in-process render of load_obj_scene;
    (d) builtin:sponza_x16 --bvh cluster (4,154,496 triangles, radix
    tree, the run-time-K form), simple, and the same scene --bvh sah;
    (e) builtin:volume --algorithm volume (the march and its brick
    table); (f) (b) with --elastic and a
    checkpoint: every batch done, none failed, the image equal to the
    checkpoint's, and an interrupted in-process run of the same frame
    resumed from its checkpoint bit-identical to it; (g) --dump-bvh of
    (b)'s tree: its stats line; (h) builtin:sponza --algorithm
    pathtracing --nee --frames 4 --pixel-format RGBA8 (the LBVH): a
    progressive RGBA8 TypedRenderTarget, its file equal to the same four
    frames blended in process into a typed target.

22. Tile sharding of the main path (parallel/tile_sharding.py): phase 3's
    scene, tree and frame (1920x1080, 1 spp, 5-bounce NEE) through
    render_image_sharded's flat pixel order, (a) on one rank of an NCCL
    group against render_pixels over the same pixel ids in this process,
    (b) on two ranks of a gloo group sharing the card against (a), at
    phase 4's image tolerance (differing pixels counted); then
    examples/inverse_rendering.py's gradient at 1080p (the MSE over the
    frame, with respect to cd and ls, all-reduced): two ranks against one
    at phase 6's limits.  Each rank's frame and gradient seconds,
    launches by mode, peak memory and host staging.
23. Config #5 (parallel/ring.py, parallel/sharded_pt.py):
    sponza_x16_scene() (4,154,496 triangles) sharded over two gloo ranks
    on the card, each keeping only its own shard (soup bytes about half
    the unsharded soup's), on the lbvh backend (traverse_lbvh.cu every
    hop) and the cluster backend (radix ClusterBVH a shard, row 1e every
    hop: its K and entry point printed); the 3840x2160, 5-bounce NEE,
    1 spp frame through render_image_geometry_sharded against the
    unsharded frame (LBVH, render_pixels in tiles) rendered here, at
    tests/test_sharded_render.py's rule; every hop launch mode held
    against the plain version as in phases 2 and 14; the soup's vertex
    gradient at 1920x1080 through soup_grads_to_faces (finite, non-zero,
    on the rank's own faces only), and kernel against plain gradients at
    32x32.  Each rank's frame and gradient seconds, hops and their payload
    bytes, host staging seconds and peak memory.
    The ranks of phases 22-23 are processes of this script
    (``--rank-worker``), spawned and waited on; a rank's failure fails the
    phase.  Their times are two ranks sharing one card over host loopback.

Output: one line per check, then a JSON line with per-kernel numbers, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile [--profile-table=PATH]

adds a torch.profiler breakdown of one more frame, radix frame, training
step, Whitted frame, AO frame, boundary step, the LBVH frames and step,
the volume frame, the textured NEE frame and the volume step: device
time by kernel group and the device idle share, and with PATH the full
operator tables (the step's in PATH.step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import visionaray_torch.kernels.volume as tvol
import visionaray_torch.ops.traversal as tt
import visionaray_torch.ops.traverse as trav
from visionaray_torch import cli
from visionaray_torch.core.camera import Pinhole
from visionaray_torch.core.scene import Planes, Scene, Spheres, TriangleMesh
from visionaray_torch.core.types import Ray
from visionaray_torch.io.camera_io import load_camera, save_camera
from visionaray_torch.io.image import load_image, save_png
from visionaray_torch.io.pixel_format import make_typed_render_target
from visionaray_torch.io.obj import load_obj_scene, save_obj
from visionaray_torch.diff.boundary import (
    boundary_image, build_edge_adjacency, silhouette_mask,
)
from visionaray_torch.kernels import pathtracing as pt
from visionaray_torch.kernels.params import KernelParams
from visionaray_torch.kernels.volume import Volumes, march_plain, volume_march
from visionaray_torch.ops import bounce_shade as bs
from visionaray_torch.ops import sah
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh
from visionaray_torch.ops.lbvh import build_lbvh, sah_cost
from visionaray_torch.ops.sampling import Sampler
from visionaray_torch.ops.trace import TraceConfig, closest_hit, multi_hit
from visionaray_torch.parallel import multihost
from visionaray_torch.sched import render as srender
from visionaray_torch.sched import step
from visionaray_torch.sched.elastic import render_frame_elastic
from visionaray_torch.sched.render import _pixel_grid, render, render_pixels
from visionaray_torch.scenes.basic import cornell_box_spectral
from visionaray_torch.scenes.sponza_like import sponza_like_scene
from visionaray_torch.scenes.volume_demo import (
    multi_volume_scene, volume_scene,
)
from visionaray_torch.shading.lights import PointLights
from visionaray_torch.shading.materials import Materials
from visionaray_torch.shading.spectrum import lift_scene, to_rgb
from visionaray_torch.shading.texture import AddressMode, Filter, TextureAtlas

WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 1, 5
TARGET_TRIS, K, T = 260_000, 32, 128
TIMED_FRAMES = 3
COMPARE_LANES = 8192
# kernel vs plain, per mode: lanes whose hit flag differs, plus closest-hit
# lanes whose prims differ at different t (a tie at equal t is allowed),
# may be at most this share of the compared live lanes; where both pick
# the same prim, t must agree to this relative error
MISMATCH_SHARE = 1e-4
T_RTOL = 1e-6
# whole-path check: the slice test's tolerance
IMG_MEAN_ABS, IMG_PIX_TOL, IMG_PIX_SHARE = 1e-4, 1e-3, 0.02
# gradient check: tests/test_torch_grad.py's tolerance
LOSS_RTOL, GRAD_REL_L2, GRAD_COS = 1e-5, 1e-3, 0.999
TIMED_STEPS = 3
# H100 SXM peaks (NVIDIA data sheet): memory rate and f32 non-tensor rate
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
FLOP_TRI, FLOP_BOX = 40, 20      # ops of one triangle / one box test
REPLACES = "visionaray_tpu/ops/pallas/traverse.py:557"
# the source of each C entry point of ops/traverse.py::launch_form
SOURCES = {"vsnray_traverse_binned":
               "visionaray_torch/ops/cuda/traverse_binned.cu",
           "vsnray_traverse_coherent":
               "visionaray_torch/ops/cuda/traverse_coherent.cu"}
COHERENT = ("closest", "any")   # the modes launched from the root
MODES = [  # (mode key, kernel name, table row) of the treelet frame
    ("closest", "traverse_closest", "1"),
    ("binned_closest", "traverse_binned_closest", "1b"),
    ("binned_any", "traverse_binned_any", "1c"),
    ("any", "traverse_any", "1d"),
]
RADIX_MODES = [("radix_closest", "traverse_radix_closest", "1e"),
               ("radix_any", "traverse_radix_any", "1e")]
C1_MODES = [("c1_closest", "traverse_c1_closest", "1e (C == 1)"),
            ("c1_any", "traverse_c1_any", "1e (C == 1)")]
# row 1f: the kernel's wide descent and half-cluster skip on the main path
OPTIONS_1F = {"fanout4": TraceConfig(fanout=4),
              "fanout8": TraceConfig(fanout=8),
              "half_skip": TraceConfig(half_skip=True),
              "fanout4_half_skip": TraceConfig(fanout=4, half_skip=True)}
STEP_1F = "fanout4_half_skip"
# phase 9: the shadow and sort-key switches, with the modes each launches
# (the coherent ones among them are held against the plain version)
SWITCHES = {
    "shadow_coherent": (TraceConfig(shadow_binned=False),
                        ("closest", "any", "binned_closest")),
    "shadow_from_surface_m6_dir_bits3": (
        TraceConfig(shadow_reversed=False, shadow_m=6, dir_bits=3),
        ("closest", "any", "binned_closest", "binned_any")),
}

# phases 10-11: the kernels' launches a frame, by mode
ALGO_LAUNCHES = {"whitted": {"radix_closest": 5, "radix_any": 4},
                 "ao": {"radix_closest": 1, "radix_any": 8}}
MULTI_HIT_K = 16
# phases 14-16: the LBVH tier's kernel, the card form of the jnp tier
# (visionaray_tpu/ops/traversal.py _traverse_one, no pallas_call)
LBVH_SOURCE = "visionaray_torch/ops/cuda/traverse_lbvh.cu"
LBVH_REPLACES = "visionaray_tpu/ops/traversal.py:33"
LBVH_ENTRY = "vsnray_traverse_lbvh"
# phase 14f: the bounce's shading kernels (no pallas_call: the card form of
# the jnp bounce body between the traversals)
BOUNCE_SOURCE = "visionaray_torch/ops/cuda/bounce_shade.cu"
BOUNCE_REPLACES = "visionaray_tpu/kernels/pathtracing.py:177"
# the fused frame against the torch body: tests/test_torch_cuda_bounce.py's
# limit (share of pixels off by more than 1e-3 in a channel)
FUSED_PIX_TOL, FUSED_PIX_SHARE = 1e-3, 1e-4
# the fused training step against the torch body: sponza_lbvh.train's
# limits of ``correct`` (benchmark/checks/sponza_lbvh.train.json)
STEP_GAPS = {"loss_gap": 1e-4, "gv_gap": 5e-3, "gcd_gap": 1e-3}
FLOP_SPHERE = 32                 # ops of one sphere test
SPHERE_COUNT = 65_536
# phase 17: textures (JAX's TextureAtlas.pack resolution), and the simple
# frame's other filters and address modes
TEX_RES = 256
TEX_VARIANTS = [("nearest", Filter.NEAREST, AddressMode.WRAP),
                ("bspline_interpol", Filter.BSPLINE_INTERPOL,
                 AddressMode.WRAP),
                ("cardinal", Filter.CARDINAL_SPLINE, AddressMode.WRAP),
                ("mirror", Filter.LINEAR, AddressMode.MIRROR),
                ("border", Filter.LINEAR, AddressMode.BORDER)]
# phase 18: the reference's sample count (spectrum.h:34), the first tile
# tried and the peak memory the tiled frame must stay under
SPECTRAL_N = 300
SPECTRAL_TILE = 524_288
SPECTRAL_PEAK = 40e9
# phase 19: the volume march, the card form of the jnp volume kernel
# (visionaray_tpu/kernels/volume.py:115, no pallas_call)
VOLUME_SOURCE = "visionaray_torch/ops/cuda/volume_march.cu"
VOLUME_REPLACES = "visionaray_tpu/kernels/volume.py:115"
VOLUME_ENTRY = "vsnray_volume_march"
VOLUME_RES = 256                 # upstream's examples/volume: 256^3
MULTI_RES, MULTI_N = 128, 3
FLOP_STEP = 100                  # f32 operations of one march step
# the steps of the 1080p primary rays at full size, every design's
# (the first design's counting form): the skip must visit the same steps
VOLUME_STEPS = {"volume": 172_730_813, "multi volume": 60_492_534}
STEPS_NOTE = {None: "not this size", True: "equal", False: "DIFFERENT"}
VOLUME_ATOL = 1e-5               # colour, kernel vs plain
RENDER_BG = (0.1, 0.4, 1.0, 1.0)   # render's default bg_color
# phase 20: the volume march's backward kernel
VOLUME_BWD_SOURCE = "visionaray_torch/ops/cuda/volume_march_bwd.cu"
VOLUME_BWD_ENTRY = "vsnray_volume_march_bwd"
FLOP_STEP_BWD = 160              # f32 operations of one backward step
# with the ray and box gradients: the trilinear slopes (8 taps, ~40) and
# the chain through p, uvw, t and dt (~30)
FLOP_STEP_BWD_ALL = 230
GRAD_BWD_REL, GRAD_BWD_COS, BG_BWD_RTOL = 1e-4, 0.9999, 1e-5
TARGET_TRANSFER_SCALE = 0.8      # the step's target: transfer x 0.8
# phase 21: the CLI at full width; x16's scene as the repo's config #5
CLI_SIZE = ["--width", str(WIDTH), "--height", str(HEIGHT)]
ELASTIC_BATCH = 1 << 16          # the CLI's default --elastic-batch
ELASTIC_STOP = 5                 # the in-process run stops at this batch
TYPED_FRAMES = 4


def reject_mod7(pid, t, u, v, hit):
    """Phase 13's hit filter: rejects every prim whose id is 0 mod 7."""
    return hit & (pid % 7 != 0)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps, after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class LaunchRecorder:
    """Stands in for traverse.cluster_traverse during the warm frame and
    keeps a copy of the inputs of every launch, by mode, in launch order."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = {}

    @property
    def first(self):
        return {mode: lns[0] for mode, lns in self.launches.items()}

    def __call__(self, rays, nodes, tris, num_clusters, cluster_size,
                 tile_lanes, any_hit=False, tile_roots=None,
                 tile_splits=None, counters=None, heap=True, depth=None,
                 fanout=2, half_skip=False):
        mode = trav.launch_mode(heap, num_clusters, tile_roots is not None,
                                any_hit)
        self.launches.setdefault(mode, []).append(dict(
            rays=rays.clone(), tile_lanes=tile_lanes, any_hit=any_hit,
            roots=None if tile_roots is None else tile_roots.clone(),
            splits=None if tile_splits is None else tile_splits.clone(),
            fanout=fanout, half_skip=half_skip))
        return self.fn(rays, nodes, tris, num_clusters, cluster_size,
                       tile_lanes, any_hit, tile_roots, tile_splits,
                       counters, heap=heap, depth=depth, fanout=fanout,
                       half_skip=half_skip)


@contextlib.contextmanager
def recorded(rec):
    """cluster_traverse replaced by the LaunchRecorder ``rec``."""
    trav.cluster_traverse = rec
    try:
        yield rec
    finally:
        trav.cluster_traverse = rec.fn


def plain_on_card(rays, nodes, tris, num_clusters, cluster_size,
                  tile_lanes, any_hit=False, tile_roots=None,
                  tile_splits=None, counters=None, heap=True, depth=None,
                  fanout=2, half_skip=False):
    """cluster_traverse's contract through the plain version, on the card
    (the kernel form, ``fanout`` and ``half_skip``, does not change it)."""
    if tile_roots is None:
        tile_roots, tile_splits = trav._default_tiles(
            rays.shape[0], tile_lanes, rays.device)
    return trav.traverse_plain(rays, nodes, tris, num_clusters,
                               cluster_size, tile_lanes, any_hit,
                               tile_roots, tile_splits, heap=heap)


@contextlib.contextmanager
def plain_traversal():
    """Every traversal through the plain version while inside."""
    kernel_fn = trav.cluster_traverse
    trav.cluster_traverse = plain_on_card
    try:
        yield
    finally:
        trav.cluster_traverse = kernel_fn


class BvhRecorder:
    """Stands in for traversal.bvh_traverse (the LBVH tier's wrapper)
    during a warm frame and keeps a copy of the inputs of every launch on
    the card, by LAUNCHES key, in launch order."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = {}

    @property
    def first(self):
        return {mode: lns[0] for mode, lns in self.launches.items()}

    def __call__(self, o, d, max_t, bvh, prim, tables, mode, k=1,
                 counters=None):
        if o.shape[0]:
            self.launches.setdefault(tt.launch_key(prim, mode), []).append(
                dict(o=o.clone(), d=d.clone(), max_t=max_t.clone(), bvh=bvh,
                     prim=prim, tables=tables, mode=mode, k=k))
        return self.fn(o, d, max_t, bvh, prim, tables, mode, k, counters)


@contextlib.contextmanager
def bvh_recorded(rec):
    """bvh_traverse replaced by the BvhRecorder ``rec``."""
    tt.bvh_traverse = rec
    try:
        yield rec
    finally:
        tt.bvh_traverse = rec.fn


@contextlib.contextmanager
def plain_bvh():
    """Every LBVH-tier search through the plain version, on the card."""
    kernel_fn = tt.bvh_traverse

    def plain(o, d, max_t, bvh, prim, tables, mode, k=1, counters=None):
        return tt.traverse_bvh_plain(o, d, max_t, bvh, prim, tables, mode, k)

    tt.bvh_traverse = plain
    try:
        yield
    finally:
        tt.bvh_traverse = kernel_fn


def full_tiles(launch):
    rays = launch["rays"]
    tl = launch["tile_lanes"]
    if launch["roots"] is None:
        roots, splits = trav._default_tiles(rays.shape[0], tl, rays.device)
    else:
        roots, splits = launch["roots"], launch["splits"]
    return rays, roots, splits, tl


def compare_tiles(rays, roots, splits, tl):
    """Tile indices for the kernel-vs-plain comparison: straddling
    (two-pass) tiles, the tile where live lanes end and dead lanes begin,
    then tiles with live lanes from the middle of those on, at least
    COMPARE_LANES lanes in all."""
    n_tiles = rays.shape[0] // tl
    live = (rays[:, 6] >= 0).reshape(n_tiles, tl)
    picked = []
    straddle = torch.nonzero(splits < tl).reshape(-1).tolist()
    picked += straddle[:: max(1, len(straddle) // 4)][:4]
    mixed = torch.nonzero(live.any(1) & ~live.all(1)).reshape(-1).tolist()
    picked += mixed[-1:]
    live_tiles = torch.nonzero(live.any(1)).reshape(-1).tolist()
    half = len(live_tiles) // 2
    for t in live_tiles[half:] + live_tiles[:half] + list(range(n_tiles)):
        if len(set(picked)) * tl >= COMPARE_LANES:
            break
        picked.append(t)
    return sorted(set(picked)), len(straddle), len(mixed)


def sub_launch(rays, roots, splits, tl, tiles):
    idx = torch.tensor(tiles, device=rays.device)
    sub_rays = rays.reshape(-1, tl, 8)[idx].reshape(-1, 8).contiguous()
    return (sub_rays, roots[:, idx].contiguous(),
            splits[idx].contiguous())


def ptxas_report(log):
    """Per kernel form in nvcc's ptxas output: registers, shared memory,
    stack frame and spill bytes, keyed by a readable form name."""
    forms, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = form_name(m.group(1))
            forms[name] = dict(regs=0, smem=0, stack=0, spill=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            forms[name].update(stack=int(m.group(1)),
                               spill=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            forms[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            forms[name]["smem"] = int(sm.group(1)) if sm else 0
    return forms


def form_name(mangled):
    """``binned any=0 count=0 fanout=2 half=0 K=32 heap=1`` or ``coherent
    any=0 count=0 K=32`` from a kernel's mangled name (K=0: the run-time-K
    form; heap=0: a radix tree)."""
    m = re.search(r"binned_kernelILb(\d)ELb(\d)ELi(\d)ELb(\d)ELi(\d+)E"
                  r"Lb(\d)E", mangled)
    if m:
        return ("binned any={} count={} fanout={} half={} K={} heap={}"
                .format(*m.groups()))
    m = re.search(r"coherent_kernelILb(\d)ELb(\d)ELi(\d+)E", mangled)
    if m:
        return "coherent any={} count={} K={}".format(*m.groups())
    m = re.search(r"lbvh_kernelILi(\d)ELi(\d)ELb(\d)ELb(\d)E", mangled)
    if m:
        prim, mode, gen, count = (int(g) for g in m.groups())
        return (f"lbvh {tt.PRIMS[prim]} {tt.MODES[mode]} "
                f"generalized={gen} count={count}")
    m = re.search(r"volume_kernelILb(\d)E(?:Lb(\d)E)?", mangled)
    if m:
        # shared=1: the transfer tables in shared memory; without it the
        # first design, which had no transfer form
        return f"volume count={m.group(1)}" + (
            f" shared={m.group(2)}" if m.group(2) else "")
    if "bricks_kernel" in mangled:
        return "volume_bricks"
    m = re.search(r"volume_bwd_kernelILb(\d)E", mangled)
    if m:
        # pos=1: with the ray and box gradients
        return f"volume_bwd pos={m.group(1)}"
    return mangled


def kernel_sass(lib_path):
    """{form name: [(address, instruction)]} of every kernel in a built
    library, from ``cuobjdump -sass``."""
    cuobjdump = Path(trav._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        head, _, rest = body.partition("\n")
        out[form_name(head.strip())] = [
            (int(a, 16), ins.strip()) for a, ins in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", rest)]
    return out


_BRA = re.compile(r"\bBRA(?:\.[A-Z.]+)?\s+`?\(?(0x[0-9a-f]+)")


def _opcode(ins):
    parts = ins.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def step_loop(instrs):
    """The march's step loop in one kernel's SASS: the smallest loop
    (from a branch target to the last branch back to it) that rounds 3
    values down (``FLOOR``: the base cell) and holds a global load.
    Returns {"loop": its instructions, "loads": its global loads,
    "empty_path": the instructions a skipped step runs, estimated from
    the layout (the loop's head to the first predicated forward branch
    after its first global load, the brick bit's, then from that branch's
    target to the next branch back to the head), "head": its address},
    or None."""
    pos = {a: i for i, (a, _) in enumerate(instrs)}
    back = {}
    for i, (a, ins) in enumerate(instrs):
        m = _BRA.search(ins)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in pos:
            t = pos[int(m.group(1), 16)]
            back[t] = max(back.get(t, i), i)
    best = None
    for head, end in back.items():
        body = instrs[head:end + 1]
        loads = sum(_opcode(ins).startswith("LDG") for _, ins in body)
        floors = sum("FLOOR" in _opcode(ins) for _, ins in body)
        if loads and floors >= 3 and (best is None
                                      or end - head < best[1] - best[0]):
            best = (head, end, loads)
    if best is None:
        return None
    head, end, loads = best
    first = next(i for i in range(head, end + 1)
                 if _opcode(instrs[i][1]).startswith("LDG"))
    empty = None
    for i in range(first, end + 1):
        m = _BRA.search(instrs[i][1])
        if m and instrs[i][1].startswith("@"):
            t = pos.get(int(m.group(1), 16))
            if t is not None and i < t <= end:
                tail = next((j for j in range(t, end + 1)
                             if (b := _BRA.search(instrs[j][1]))
                             and pos.get(int(b.group(1), 16)) == head), end)
                empty = (i - head + 1) + (tail - t + 1)
            break
    return {"loop": end - head + 1, "loads": loads, "empty_path": empty,
            "head": instrs[head][0]}


def ptxas_lines(log, main_path=False):
    """One line per kernel form; ``main_path``: only the non-counting forms
    that the main path's frame and its 1f options (K=32, heap), the radix
    frames (K=32, and K=40 in the run-time-K form) and the LBVH tier run."""
    out = []
    for name, f in ptxas_report(log).items():
        if main_path and ("count=1" in name or (
                "K=32" not in name and not name.endswith("K=0 heap=0")
                and not name.startswith(("lbvh", "volume")))):
            continue
        out.append(f"{name}: {f['regs']} registers, {f['smem']} B smem, "
                   f"{f['stack']} B stack, {f['spill']} B spills")
    return out


def check_mode(key, name, row, launches, bvh, count):
    """Kernel vs plain version on the captured launches of one mode,
    relaunched in the form (fanout, half_skip) they were captured with:
    the first, a middle and the last launch compared on a subset of tiles;
    every launch timed, its counters sizing its bound."""
    first = launches[0]
    any_hit = first["any_hit"]
    binned = first["roots"] is not None
    C, Kc = bvh.num_clusters, bvh.cluster_size
    fanout, half_skip = first["fanout"], first["half_skip"]

    entry = trav.launch_form(bvh.heap, C, binned, any_hit, fanout,
                             half_skip, Kc)[0]

    def kernel(r, ro, sp, tl, counters=None):
        return trav.cluster_traverse(
            r, bvh.nodes, bvh.tris, C, Kc, tile_lanes=tl, any_hit=any_hit,
            tile_roots=ro if binned else None,
            tile_splits=sp if binned else None, counters=counters,
            heap=bvh.heap, depth=bvh.depth, fanout=fanout,
            half_skip=half_skip)

    def plain(r, ro, sp, tl):
        return trav.traverse_plain(r, bvh.nodes, bvh.tris, C, Kc, tl,
                                   any_hit, ro, sp, heap=bvh.heap)

    # correctness on a subset of tiles of the first, a middle and the last
    # launch
    compared = sorted({0, len(launches) // 2, len(launches) - 1})
    hit_mm = prim_mm = n_live = n_lanes = n_straddle = n_mixed = 0
    max_rel = max_abs = 0.0
    for idx in compared:
        rays, roots, splits, tl = full_tiles(launches[idx])
        tiles, straddle, mixed = compare_tiles(rays, roots, splits, tl)
        sr, sro, ssp = sub_launch(rays, roots, splits, tl, tiles)
        kt, kp, ku, kv = kernel(sr, sro, ssp, tl)
        pt, pp, pu, pv = plain(sr, sro, ssp, tl)
        torch.cuda.synchronize()
        live = sr[:, 6] >= 0
        kh, ph = kp >= 0, pp >= 0
        hit_mm += int((live & (kh != ph)).sum())
        n_live += int(live.sum())
        n_lanes += sr.shape[0]
        n_straddle += straddle
        n_mixed += mixed
        if any_hit:
            max_abs = max(max_abs, float((kh != ph).float().max()))
        else:
            both = live & kh & ph
            same = both & (kp == pp)
            prim_mm += int((both & (kp != pp) & (kt != pt)).sum())
            dt = (kt - pt).abs()[same]
            rel = dt / pt.abs()[same].clamp_min(1e-30)
            uv = torch.maximum((ku - pu).abs(), (kv - pv).abs())[same]
            if dt.numel():
                max_abs = max(max_abs, float(dt.max()), float(uv.max()))
                max_rel = max(max_rel, float(rel.max()))
        if idx == 0:
            plain_ms = cuda_ms(lambda: plain(sr, sro, ssp, tl), 1)
            kernel_cmp_ms = cuda_ms(lambda: kernel(sr, sro, ssp, tl), 5)

    # every launch: time, counters, bound
    launch_ms, bounds, live_lanes, tests = [], [], [], [0, 0]
    for idx, ln in enumerate(launches):
        rays, roots, splits, tl = full_tiles(ln)
        npad = rays.shape[0]
        launch_ms.append(cuda_ms(lambda: kernel(rays, roots, splits, tl), 5))
        counters = torch.zeros((npad, 2), dtype=torch.int32,
                               device=rays.device)
        kernel(rays, roots, splits, tl, counters)
        tot = counters.sum(0, dtype=torch.int64).tolist()
        tests[0] += tot[0]
        tests[1] += tot[1]
        bytes_moved = (npad * 8 * 4 + bvh.nodes.numel() * 4
                       + bvh.tris.numel() * 4 + roots.numel() * 4
                       + splits.numel() * 4 + 4 * npad * 4)
        ops = FLOP_TRI * tot[1] + FLOP_BOX * tot[0]
        bounds.append((bytes_moved / PEAK_BYTES_S * 1e3,
                       ops / PEAK_F32_S * 1e3))
        live_lanes.append(int((rays[:, 6] >= 0).sum()))
    t_bytes, t_ops = bounds[0]
    bound_frame = sum(max(b) for b in bounds)
    ms_frame = sum(launch_ms)
    ok = (hit_mm + prim_mm <= MISMATCH_SHARE * max(n_live, 1)
          and max_rel <= T_RTOL)
    src = SOURCES[entry]
    log(f"kernel {row} {name} (fanout={fanout} half_skip={half_skip}) "
        f"[{src.rsplit('/', 1)[1]}]: compared launches {compared} "
        f"lanes={n_lanes} live={n_live} straddling_tiles_in_launches="
        f"{n_straddle} live_dead_tiles_in_launches={n_mixed} "
        f"hit_mismatch={hit_mm} prim_mismatch_unique={prim_mm} "
        f"max_rel_t={max_rel:.3e} kernel_ms_compare={kernel_cmp_ms:.4f} "
        f"plain_ms={plain_ms:.3f} | first launch lanes="
        f"{first['rays'].shape[0]} live={live_lanes[0]} ms={launch_ms[0]:.4f}"
        f" bound_ms={max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) | "
        f"{len(launches)} launches: ms_sum={ms_frame:.4f} "
        f"bound_ms_sum={bound_frame:.4f} box_tests={tests[0]} "
        f"tri_tests={tests[1]} {'OK' if ok else 'FAIL'}")
    if len(launches) > 1:
        log(f"  launch ms {[round(t, 4) for t in launch_ms]} live lanes "
            f"{live_lanes}")
    return ok, {
        "name": name, "route": "cuda", "source": src, "entry": entry,
        "replaces": REPLACES, "mode": row, "mode_key": key,
        "launches": count.get(key, 0),
        "max_abs_err": max_abs, "ms": launch_ms[0], "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "lanes": first["rays"].shape[0],
        "ms_frame": ms_frame, "bound_ms_frame": bound_frame,
        "launch_ms": launch_ms, "launch_live_lanes": live_lanes,
        "compared_launches": compared, "compare_lanes": n_lanes,
        "kernel_ms_compare": kernel_cmp_ms, "hit_mismatch": hit_mm,
        "prim_mismatch_unique": prim_mm, "max_rel_t": max_rel,
        "box_tests": tests[0], "tri_tests": tests[1],
        "variant": trav.variant_key(key, fanout, half_skip),
    }


def swizzled_pixels(device):
    """bench.py's 64x64 pixel-block order."""
    B = 64
    Wp, Hp = -(-WIDTH // B) * B, -(-HEIGHT // B) * B
    yy, xx = np.meshgrid(np.arange(Hp), np.arange(Wp), indexing="ij")
    inb = (xx < WIDTH) & (yy < HEIGHT)
    order = (yy // B) * (Wp // B) + (xx // B)
    flat = np.argsort(np.where(inb, order, 1 << 30).reshape(-1),
                      kind="stable")[: WIDTH * HEIGHT]
    x = torch.as_tensor(xx.reshape(-1)[flat], dtype=torch.int32,
                        device=device)
    y = torch.as_tensor(yy.reshape(-1)[flat], dtype=torch.int32,
                        device=device)
    return x, y


def small_config(device, lbvh=False):
    """sponza_like 4000 (4,804 triangles), K=8, T=16, 3 bounces; ``lbvh``:
    on the scene's default LBVH instead."""
    scene, cam = sponza_like_scene(target_tris=4000, build_bvh=lbvh,
                                   device=device)
    if not lbvh:
        scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=8,
                                      treelet_size=16)
    params = KernelParams.create(scene, num_bounces=3, epsilon=1e-3,
                                 bg_color=(0.2, 0.3, 0.5, 1.0),
                                 ambient_color=(1.0, 1.0, 1.0, 1.0))
    return params, cam


def whole_path_check(device, lbvh=False):
    """Small config through the kernel and through the plain version."""
    params, cam = small_config(device, lbvh)
    x, y = _pixel_grid(64, 64, device)

    def frame():
        return render_pixels(params, cam, x, y, 64, 64, "pathtracing", 1,
                             "jittered_blend", 1, nee=True)[0]

    trav.reset_launch_counts()
    img_k = frame()
    launched = sum(trav.LAUNCHES.values())
    with (plain_bvh() if lbvh else plain_traversal()):
        img_p = frame()
    diff = (img_k - img_p).abs()
    mean_abs = float(diff.mean())
    share = float((diff.amax(-1) > IMG_PIX_TOL).float().mean())
    ok = bool(torch.isfinite(img_k).all()) and mean_abs <= IMG_MEAN_ABS \
        and share <= IMG_PIX_SHARE and launched > 0
    log(f"whole path 64x64{' on the LBVH' if lbvh else ''} kernel vs plain "
        f"({launched} launches): mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} "
        f"image_mean={float(img_k.mean()):.6f} {'OK' if ok else 'FAIL'}")
    return ok


def grad_stats(got, ref):
    """(relative L2 error, cosine) of two gradients."""
    got, ref = got.double(), ref.double()
    rel = float((got - ref).norm() / ref.norm())
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    return rel, cos


def training_step_phase(params, cam, x, y, label="training step",
                        modes=None):
    """Phase 5 (and phase 8's and 14's steps): bench.py's training step at
    full width under ``params``; ``modes``: the LAUNCHES keys its forward
    must launch (default: the main path's)."""
    need = [k for k, _, _ in MODES] if modes is None else list(modes)
    verts = params.scene.mesh.vertices
    cd = params.scene.materials.cd
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.loss_and_grads(verts, cd, 1, params, cam, x, y, nee=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # the counted step: forward and backward apart, peak memory (also as
    # the increment over what earlier phases left allocated)
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        v = verts.detach().requires_grad_()
        c = cd.detach().requires_grad_()
        trav.reset_launch_counts()
        t0 = time.perf_counter()
        loss = step.frame_loss(v, c, 2, params, cam, x, y, nee=True)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        fwd = dict(trav.LAUNCHES)
        fwd_variants = dict(trav.VARIANT_LAUNCHES)
        fwd_entries = dict(trav.ENTRY_LAUNCHES)
        trav.reset_launch_counts()
        t0 = time.perf_counter()
        g_v, g_c = torch.autograd.grad(loss, (v, c))
        torch.cuda.synchronize()
        bwd_s = time.perf_counter() - t0
        bwd = dict(trav.LAUNCHES)
        bwd_entries = dict(trav.ENTRY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    times = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss_t, (gv_t, gc_t) = step.loss_and_grads(verts, cd, 3 + i, params,
                                                   cam, x, y, nee=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)
    rays = WIDTH * HEIGHT * SPP * BOUNCES * 2
    finite = all(bool(torch.isfinite(t).all())
                 for t in (loss, g_v, g_c, loss_t, gv_t, gc_t))
    nonzero = float(g_v.abs().sum()) > 0 and float(g_c.abs().sum()) > 0
    bwd_launches = sum(bwd.values())
    ok = (finite and nonzero and bwd_launches == 0
          and all(fwd[k] > 0 for k in need))
    lanes = -(-x.shape[0] // step.TILE) * step.TILE
    log(f"{label} 1920x1080 spp=1 bounces=5 nee ({lanes} lanes, "
        f"{lanes - x.shape[0]} padding): step_s={step_s:.4f} (steps "
        f"{', '.join(f'{t:.4f}' for t in times)}) "
        f"mrays_per_s={rays / step_s / 1e6:.3f} warm_s={warm_s:.3f} "
        f"counted step forward_s={fwd_s:.4f} backward_s={bwd_s:.4f} "
        f"peak_mem_bytes={peak} step_mem_bytes={peak - base_mem} "
        f"loss={float(loss.detach()):.7f} "
        f"|g_verts|={float(g_v.norm()):.6e} |g_cd|={float(g_c.norm()):.6e} "
        f"finite={finite} nonzero={nonzero}")
    log(f"  forward launches={fwd} by kernel form={fwd_variants} by entry "
        f"point={fwd_entries} backward launches={bwd} by entry point="
        f"{bwd_entries} {'OK' if ok else 'FAIL'}")
    return ok, dict(step_s=step_s, mrays_per_s=rays / step_s / 1e6,
                    step_times=times, forward_s=fwd_s, backward_s=bwd_s,
                    peak_mem_bytes=peak, step_mem_bytes=peak - base_mem,
                    loss=float(loss.detach()),
                    forward_launches=fwd, forward_variants=fwd_variants,
                    forward_entries=fwd_entries,
                    backward_launches=bwd_launches,
                    backward_entries=bwd_entries)


def grad_check(device, lbvh=False):
    """Phase 6: loss_and_grads through the kernel and through the plain
    version at 32x32 on phase 4's configuration (``lbvh``: on its LBVH)."""
    params, cam = small_config(device, lbvh)
    x, y = _pixel_grid(32, 32, device)
    verts = params.scene.mesh.vertices
    cd = params.scene.materials.cd

    def run():
        return step.loss_and_grads(verts, cd, 1, params, cam, x, y, nee=True,
                                   width=32, height=32, tile=32 * 32)

    loss_k, grads_k = run()
    with (plain_bvh() if lbvh else plain_traversal()):
        loss_p, grads_p = run()
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    stats = [grad_stats(a, b) for a, b in zip(grads_k, grads_p)]
    ok = (loss_rel <= LOSS_RTOL and all(
        rel <= GRAD_REL_L2 and cos >= GRAD_COS for rel, cos in stats)
        and all(bool(torch.isfinite(g).all()) for g in grads_k))
    log(f"gradient check 32x32{' on the LBVH' if lbvh else ''} kernel vs "
        f"plain: loss_rel={loss_rel:.3e} "
        f"g_verts rel_l2={stats[0][0]:.3e} cos={stats[0][1]:.9f} "
        f"g_cd rel_l2={stats[1][0]:.3e} cos={stats[1][1]:.9f} "
        f"{'OK' if ok else 'FAIL'}")
    return ok


def timed_frames(frame, lbvh=False):
    """Warm frame with the first launch of each mode recorded, a counted
    frame (counts reset just before), then more timed frames.  ``lbvh``:
    record the LBVH tier's launches (bvh_traverse), not the ClusterBVH's."""
    rec = BvhRecorder(tt.bvh_traverse) if lbvh else \
        LaunchRecorder(trav.cluster_traverse)
    with (bvh_recorded(rec) if lbvh else recorded(rec)):
        t0 = time.perf_counter()
        frame(1)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    trav.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, depth = frame(2)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = dict(trav.LAUNCHES)
    rec.variants = dict(trav.VARIANT_LAUNCHES)
    rec.entries = dict(trav.ENTRY_LAUNCHES)
    for i in range(TIMED_FRAMES - 1):
        t0 = time.perf_counter()
        frame(3 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return rec, launches, warm_s, times, color, depth


def radix_phase(scene, cam, cpu_mesh, dev):
    """Phase 7a set-up: the radix tree of the 260k scene, checked against
    the CPU build, and its 1080p frame."""
    t0 = time.perf_counter()
    rbvh = build_cluster_bvh(scene.mesh, treelet_size=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cpu_bvh = build_cluster_bvh(cpu_mesh, treelet_size=0)
    same = (all(torch.equal(getattr(rbvh, k).cpu(), getattr(cpu_bvh, k))
                for k in ("nodes", "tris"))
            and rbvh.depth == cpu_bvh.depth)
    shape_ok = (rbvh.cluster_size, rbvh.num_clusters,
                rbvh.nodes.shape[0], rbvh.heap) == (32, 8115, 16229, False)
    log(f"radix tree: bvh_build_s={build_s:.3f} C={rbvh.num_clusters} "
        f"K={rbvh.cluster_size} nodes={rbvh.nodes.shape[0]} "
        f"depth={rbvh.depth} tables_equal_to_cpu_build={same}")
    params = KernelParams.create(
        dataclasses.replace(scene, bvh=rbvh), num_bounces=BOUNCES,
        epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
        ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = swizzled_pixels(dev)

    def frame(num):
        return render_pixels(params, cam, x, y, WIDTH, HEIGHT,
                             "pathtracing", SPP, "jittered_blend", num,
                             nee=True)

    return rbvh, frame, same and shape_ok, build_s


def simple_phase(scene, cam, label, check_modes):
    """Phase 7c: render(scene, cam, 1920, 1080) with defaults only (the
    simple kernel) on a radix tree, timed as phase 3: exactly one
    radix_closest launch, its image finite and mostly hit, the launch held
    against the plain version."""
    def frame(num):
        rt = render(scene, cam, WIDTH, HEIGHT)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    finite = bool(torch.isfinite(color).all())
    hit = float((depth > 0).float().mean())
    K = scene.bvh.cluster_size
    ok = (finite and hit > 0.5 and launches["radix_closest"] == 1
          and sum(launches.values()) == 1
          and rec.entries["vsnray_traverse_binned"] == 1)
    log(f"simple frame{label} 1920x1080 render() defaults on the radix tree "
        f"(K={K} C={scene.bvh.num_clusters}): simple_frame_s={frame_s:.4f} "
        f"(frames {', '.join(f'{t:.4f}' for t in times)}) "
        f"warm_s={warm_s:.3f} launches={launches} entry_launches="
        f"{rec.entries} hit_fraction={hit:.4f} image_mean="
        f"{float(color[:, :3].mean()):.6f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")
    ok &= check_modes([("radix_closest", f"traverse_radix_closest_simple"
                        f"{label}", "1e")], rec, scene.bvh, launches)
    return ok, frame_s


def c1_scene(device):
    """24 triangles in one cluster (K=32 gives C == 1), lit by a point
    light, seen by a camera in front: phase 7b."""
    rng = np.random.default_rng(3)
    verts = rng.uniform(-1, 1, (72, 3)).astype(np.float32)
    faces = np.arange(72, dtype=np.int32).reshape(24, 3)
    mesh = TriangleMesh.create(verts, faces, device=device)
    scene = Scene.create(
        mesh=mesh, lights=PointLights.create((2.0, 3.0, 4.0),
                                             device=device),
        bvh=build_cluster_bvh(mesh, cluster_size=32), device=device)
    cam = Pinhole.create((0.0, 0.5, 4.0), (0.0, 0.0, 0.0), device=device)
    return scene, cam


def image_diff(img, ref):
    """(mean abs difference, share of pixels off by more than IMG_PIX_TOL)
    of two (N, 4) images."""
    diff = (img - ref).abs()
    return (float(diff.mean()),
            float((diff.amax(-1) > IMG_PIX_TOL).float().mean()))


def option_phase(option, cfg, params, cam, x, y, ref_color, check_modes):
    """Phase 8, one 1f option: the 1080p frame under ``cfg``, timed as
    phase 3, its launches by kernel form, its image against the default
    frame's, and its modes against the plain version."""
    p1 = dataclasses.replace(params, trace=cfg)

    def frame(num):
        return render_pixels(p1, cam, x, y, WIDTH, HEIGHT, "pathtracing",
                             SPP, "jittered_blend", num, nee=True)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    forms = {trav.variant_key(k, cfg.fanout, cfg.half_skip)
             for k, _, _ in MODES}
    mean_abs, share = image_diff(color, ref_color)
    finite = bool(torch.isfinite(color).all())
    std = float(color[:, :3].std())
    hit = float((depth > 0).float().mean())
    ok = (finite and std > 0 and hit > 0.5 and set(rec.variants) == forms
          and mean_abs <= IMG_MEAN_ABS and share <= IMG_PIX_SHARE)
    log(f"1f {option} frame 1920x1080 spp=1 bounces=5 nee: "
        f"frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches={rec.variants} hit_fraction={hit:.4f} "
        f"image_std={std:.6f} vs default frame: mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")
    per_mode = {k: rec.variants.get(
        trav.variant_key(k, cfg.fanout, cfg.half_skip), 0)
        for k, _, _ in MODES}
    modes = [(k, f"{name}_{option}", "1f") for k, name, _ in MODES]
    ok &= check_modes(modes, rec, params.scene.bvh, per_mode)
    return ok, dict(frame_s=frame_s, frame_times=times, warm_s=warm_s,
                    launches=rec.variants, image_mean_abs_vs_default=mean_abs,
                    image_share_over_tol_vs_default=share)


def switch_phase(name, cfg, expect, params, cam, x, y, ref_color,
                 check_modes):
    """Phase 9, one switch setting: a counted 1080p frame, its coherent
    modes against the plain version on its captured launches."""
    p1 = dataclasses.replace(params, trace=cfg)
    rec = LaunchRecorder(trav.cluster_traverse)
    trav.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded(rec):
        color, depth = render_pixels(p1, cam, x, y, WIDTH, HEIGHT,
                                     "pathtracing", SPP, "jittered_blend", 2,
                                     nee=True)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = dict(trav.LAUNCHES)
    entries = dict(trav.ENTRY_LAUNCHES)
    mean_abs, share = image_diff(color, ref_color)
    finite = bool(torch.isfinite(color).all())
    std = float(color[:, :3].std())
    ok = (finite and std > 0 and all(launches[k] > 0 for k in expect)
          and sum(launches.values()) == sum(launches[k] for k in expect))
    log(f"switches {name} ({cfg}): frame 1920x1080 frame_s={frame_s:.4f} "
        f"(one frame, kernel warm) launches={launches} "
        f"entry_launches={entries} "
        f"image_std={std:.6f} vs default frame: mean_abs={mean_abs:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={share:.4f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")
    modes = [(k, f"{n}_{name}", row) for k, n, row in MODES
             if k in COHERENT and k in expect]
    ok &= check_modes(modes, rec, params.scene.bvh, launches)
    return ok, dict(frame_s=frame_s, launches=launches,
                    entry_launches=entries,
                    image_mean_abs_vs_default=mean_abs,
                    image_share_over_tol_vs_default=share)


def algo_phase(rscene, cam, algo, check_modes):
    """Phases 10-11: render(scene on the radix tree, cam, 1920, 1080,
    algo=algo) with defaults only, timed as phase 3; AO frames blend into
    the previous frame's RenderTarget."""
    state = {}

    def frame(num):
        rt = render(rscene, cam, WIDTH, HEIGHT, algo=algo, frame_num=num,
                    rt=state.get("rt") if algo == "ao" else None)
        state["rt"] = rt
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    expect = ALGO_LAUNCHES[algo]
    finite = bool(torch.isfinite(color).all())
    std = float(color[:, :3].std())
    hit = float((depth > 0).float().mean())
    ok = (finite and std > 0 and hit > 0.5
          and all(launches[k] == n for k, n in expect.items())
          and sum(launches.values()) == sum(expect.values()))
    log(f"{algo} frame 1920x1080 render() defaults on the radix tree: "
        f"{algo}_frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches={launches} (expected {expect}) entry_launches="
        f"{rec.entries} hit_fraction={hit:.4f} image_mean="
        f"{float(color[:, :3].mean()):.6f} image_std={std:.6f} "
        f"finite={finite} {'OK' if ok else 'FAIL'}")
    ok &= check_modes([(k, f"traverse_{k}_{algo}", "1e") for k in expect],
                      rec, rscene.bvh, launches)
    return ok, dict(frame_s=frame_s, frame_times=times, warm_s=warm_s,
                    launches=launches)


def _boundary_grad(scene, cam, width, height, adj):
    """(loss, vertex gradient) of the mean RGB of render(..., "simple",
    boundary=adj); ``adj=None``: no boundary term."""
    v = scene.mesh.vertices.detach().requires_grad_()
    s2 = dataclasses.replace(
        scene, mesh=dataclasses.replace(scene.mesh, vertices=v))
    with torch.enable_grad():
        rt = render(s2, cam, width, height, algo="simple", boundary=adj)
        loss = rt.color[..., :3].mean()
        (g,) = torch.autograd.grad(loss, v)
    return loss.detach(), g


def boundary_phase(rscene, cam, check_modes, dev):
    """Phase 12: the boundary step at full width on the radix tree, and
    its gradient check at 32x32 on phase 6's configuration."""
    mesh = rscene.mesh
    t0 = time.perf_counter()
    adj = build_edge_adjacency(mesh.faces.cpu().numpy(),
                               mesh.vertices.cpu().numpy(), device=dev)
    torch.cuda.synchronize()
    adj_s = time.perf_counter() - t0
    E = adj.edges.shape[0]
    with torch.no_grad():
        n_sil = int(silhouette_mask(mesh.vertices, mesh.faces, adj, cam.eye,
                                    geom_ids=mesh.geom_ids).sum())

    rec = LaunchRecorder(trav.cluster_traverse)
    with recorded(rec):
        t0 = time.perf_counter()
        _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trav.reset_launch_counts()
    t0 = time.perf_counter()
    loss, g = _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(trav.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)

    loss_nb, g_nb = _boundary_grad(rscene, cam, WIDTH, HEIGHT, None)
    v = mesh.vertices.detach().requires_grad_()
    with torch.enable_grad():
        bimg = boundary_image(
            KernelParams.create(dataclasses.replace(
                rscene, mesh=dataclasses.replace(mesh, vertices=v))),
            cam, WIDTH, HEIGHT, adj)
    zero = float(bimg.detach().abs().max()) == 0.0
    finite = bool(torch.isfinite(g).all())
    differs = not torch.equal(g, g_nb)
    ok = (finite and differs and zero and float(loss) == float(loss_nb)
          and launches.get("radix_closest", 0) == 3
          and sum(launches.values()) == 3)
    log(f"boundary step 1920x1080 render(simple, boundary=adj) on the radix "
        f"tree: boundary_step_s={step_s:.4f} (steps "
        f"{', '.join(f'{t:.4f}' for t in times)}) counted_s={counted_s:.4f} "
        f"warm_s={warm_s:.3f} adjacency_s={adj_s:.3f} edges={E} "
        f"silhouette_edges={n_sil} peak_mem_bytes={peak} "
        f"step_mem_bytes={peak - base_mem} launches={launches} "
        f"loss={float(loss):.7f} |g|={float(g.norm()):.6e} "
        f"|g without boundary|={float(g_nb.norm()):.6e} "
        f"|g - g without|={float((g - g_nb).norm()):.6e} finite={finite} "
        f"differs={differs} boundary_image_zero={zero} "
        f"{'OK' if ok else 'FAIL'}")
    ok &= check_modes([("radix_closest", "traverse_radix_closest_boundary",
                        "1e")], rec, rscene.bvh, launches)

    # kernel vs plain gradients at 32x32, phase 6's configuration
    params, scam = small_config(dev)
    sadj = build_edge_adjacency(params.scene.mesh.faces.cpu().numpy(),
                                params.scene.mesh.vertices.cpu().numpy(),
                                device=dev)
    _, gk = _boundary_grad(params.scene, scam, 32, 32, sadj)
    with plain_traversal():
        _, gp = _boundary_grad(params.scene, scam, 32, 32, sadj)
    rel, cos = grad_stats(gk, gp)
    good = (rel <= GRAD_REL_L2 and cos >= GRAD_COS
            and bool(torch.isfinite(gk).all()) and float(gp.norm()) > 0)
    log(f"boundary gradient check 32x32 kernel vs plain: g_verts "
        f"rel_l2={rel:.3e} cos={cos:.9f} |g|={float(gp.norm()):.6e} "
        f"{'OK' if good else 'FAIL'}")
    return ok and good, dict(
        boundary_step_s=step_s, step_times=times, counted_s=counted_s,
        adjacency_s=adj_s, edges=E, silhouette_edges=n_sil,
        peak_mem_bytes=peak, step_mem_bytes=peak - base_mem,
        launches=launches, grad_check_rel_l2=rel, grad_check_cos=cos)


def filter_phase(rscene, cam, check_modes, dev):
    """Phase 13: the filtered simple frame and multi_hit on the primary
    rays of the radix tree."""
    def frame(num):
        rt = render(rscene, cam, WIDTH, HEIGHT, hit_filter=reject_mod7)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    filtered_s = sum(times) / len(times)
    n = launches.get("radix_closest", 0)
    finite = bool(torch.isfinite(color).all())
    hit_frac = float((depth > 0).float().mean())
    ok = (finite and hit_frac > 0.5 and 1 <= n <= 16
          and sum(launches.values()) == n)

    x, y = _pixel_grid(WIDTH, HEIGHT, dev)
    ray = cam.primary_rays(x, y, WIDTH, HEIGHT)
    ref = closest_hit(ray, rscene)
    got = closest_hit(ray, rscene, hit_filter=reject_mod7)
    kept_rejected = int((got.hit & (got.prim_id % 7 == 0)).sum())
    acc = ref.hit & (ref.prim_id % 7 != 0)
    fell = ref.hit & ~acc
    same = (bool(got.hit[acc].all())
            and torch.equal(got.prim_id[acc], ref.prim_id[acc])
            and torch.equal(got.t[acc], ref.t[acc]))
    behind = bool((got.t[fell] > ref.t[fell]).all())
    ok &= kept_rejected == 0 and same and behind
    log(f"filtered frame 1920x1080 render(hit_filter=prim % 7 != 0) on the "
        f"radix tree: filtered_frame_s={filtered_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches (1 + re-traces)={launches} hit_fraction={hit_frac:.4f} "
        f"| primary rays: unfiltered winners rejected={int(fell.sum())} "
        f"accepted={int(acc.sum())} accepted prims the filter rejects="
        f"{kept_rejected} accepted winners same prim and t bit-equal={same} "
        f"fell-through hits behind the rejected={behind} "
        f"{'OK' if ok else 'FAIL'}")
    ok &= check_modes([("radix_closest", "traverse_radix_closest_filtered",
                        "1e")], rec, rscene.bvh, launches)

    # multi_hit on the primary rays
    mrec = LaunchRecorder(trav.cluster_traverse)
    with recorded(mrec):
        multi_hit(ray, rscene, k=MULTI_HIT_K)
        torch.cuda.synchronize()
    trav.reset_launch_counts()
    mtimes = []
    for i in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        mh = multi_hit(ray, rscene, k=MULTI_HIT_K)
        torch.cuda.synchronize()
        mtimes.append(time.perf_counter() - t0)
        if i == 0:
            mlaunches = dict(trav.LAUNCHES)
    mh_s = sum(mtimes) / len(mtimes)
    sorted_k = bool((mh.t[:, 1:] >= mh.t[:, :-1]).all())
    h0 = mh.hit[:, 0]
    slot0 = (torch.equal(h0, ref.hit)
             and torch.equal(mh.prim_id[h0, 0], ref.prim_id[h0]))
    rel0 = float(((mh.t[h0, 0] - ref.t[h0]).abs()
                  / ref.t[h0].abs().clamp_min(1e-30)).max())
    depth_hist = torch.bincount(mh.hit.sum(1), minlength=MULTI_HIT_K + 1)
    # every slot against the plain version on a subset of lanes
    mid = x.shape[0] // 2
    sub = Ray(ori=ray.ori[mid:mid + COMPARE_LANES],
              dir=ray.dir[mid:mid + COMPARE_LANES])
    km = multi_hit(sub, rscene, k=MULTI_HIT_K)
    with plain_traversal():
        pm = multi_hit(sub, rscene, k=MULTI_HIT_K)
    torch.cuda.synchronize()
    hit_mm = int((km.hit != pm.hit).sum())
    both = km.hit & pm.hit
    prim_mm = int((both & (km.prim_id != pm.prim_id) & (km.t != pm.t)).sum())
    live = int(pm.hit.sum())
    good = (sorted_k and slot0 and rel0 <= T_RTOL
            and mlaunches.get("radix_closest", 0) == MULTI_HIT_K
            and sum(mlaunches.values()) == MULTI_HIT_K
            and hit_mm + prim_mm <= MISMATCH_SHARE * max(live, 1) + 1
            and live > COMPARE_LANES)
    log(f"multi_hit 1920x1080 primary rays k={MULTI_HIT_K} on the radix "
        f"tree: multi_hit_s={mh_s:.4f} (calls "
        f"{', '.join(f'{t:.4f}' for t in mtimes)}) launches={mlaunches} "
        f"t sorted along k={sorted_k} slot 0 = closest hit={slot0} "
        f"max_rel_t_slot0={rel0:.3e} lanes by hits found="
        f"{depth_hist.tolist()} | {COMPARE_LANES} lanes vs plain: "
        f"hits={live} hit_mismatch={hit_mm} prim_mismatch_unique={prim_mm} "
        f"{'OK' if good else 'FAIL'}")
    good &= check_modes([("radix_closest",
                          "traverse_radix_closest_multi_hit", "1e")],
                        mrec, rscene.bvh, mlaunches)
    return ok and good, dict(
        filtered_frame_s=filtered_s, filtered_frame_times=times,
        filtered_launches=launches, multi_hit_s=mh_s,
        multi_hit_times=mtimes, multi_hit_launches=mlaunches)


def lbvh_subset(max_t):
    """Lanes of one LBVH launch for the comparison: COMPARE_LANES live lanes
    evenly spread over the launch (all of them when fewer), then dead lanes
    up to COMPARE_LANES."""
    n = max_t.shape[0]
    live = torch.nonzero(max_t > 0).reshape(-1)
    dead = torch.nonzero(~(max_t > 0)).reshape(-1)
    if live.numel() > COMPARE_LANES:
        pick = torch.linspace(0, live.numel() - 1, COMPARE_LANES,
                              device=max_t.device).long()
        return live[pick]
    rest = min(COMPARE_LANES - live.numel(), dead.numel())
    idx = torch.cat([live, dead[:rest]])
    return idx if idx.numel() else torch.arange(min(n, 1),
                                                device=max_t.device)


def lbvh_bytes(ln):
    """Bytes one LBVH launch must move: each input read once (lanes, node
    and leaf tables, primitive tables), each output written once."""
    bvh, n, k = ln["bvh"], ln["o"].shape[0], ln["k"]
    tables = [bvh.node_lo, bvh.node_hi, bvh.left, bvh.right, bvh.prim_ids,
              *ln["tables"]]
    if bvh.leaf_first is not None:
        tables += [bvh.leaf_first, bvh.leaf_count]
    return n * 7 * 4 + sum(x.numel() * 4 for x in tables) + n * k * 8


def lbvh_pack_ms(bvh, prim, tables):
    """Milliseconds to pack a tree's node records and its primitive
    records for traverse_lbvh.cu (ops/traversal.py pack_nodes and
    pack_prims, as kernel_pack builds them once per BVH): set-up, not
    part of a launch."""
    return cuda_ms(lambda: (tt.pack_nodes(bvh),
                            tt.pack_prims(bvh, prim, tables)), 3)


def check_lbvh_mode(key, name, launches, count):
    """traverse_lbvh.cu vs its plain version on the captured launches of one
    mode: the first, a middle and the last launch compared on
    lbvh_subset's lanes (hit equal everywhere, t equal on the same ref,
    ref equal where t differs; any-hit: ref equal); every launch timed and
    run once more with counters for its bound."""
    kernel = tt.bvh_traverse
    first = launches[0]
    mode, prim = first["mode"], first["prim"]
    gen = first["bvh"].leaf_first is not None
    compared = sorted({0, len(launches) // 2, len(launches) - 1})
    hit_mm = ref_mm = n_lanes = n_live = n_hits = 0
    max_rel = max_abs = 0.0
    for i in compared:
        ln = launches[i]
        idx = lbvh_subset(ln["max_t"])
        args = (ln["o"][idx].contiguous(), ln["d"][idx].contiguous(),
                ln["max_t"][idx].contiguous(), ln["bvh"], prim, ln["tables"],
                mode, ln["k"])
        kt, kr = kernel(*args)
        pt, pr = tt.traverse_bvh_plain(*args)
        torch.cuda.synchronize()
        kh, ph = kr >= 0, pr >= 0
        hit_mm += int((kh != ph).sum())
        if mode == "any":
            ref_mm += int((kr != pr).sum())
        else:
            ref_mm += int(((kr != pr) & (kt != pt)).sum())
        same = kh & ph & (kr == pr)
        if bool(same.any()):
            dt = (kt - pt).abs()[same]
            max_abs = max(max_abs, float(dt.max()))
            max_rel = max(max_rel, float(
                (dt / pt.abs()[same].clamp_min(1e-30)).max()))
        n_lanes += idx.numel()
        n_live += int((args[2] > 0).sum())
        n_hits += int(ph.sum())
        if i == 0:
            plain_ms = cuda_ms(lambda: tt.traverse_bvh_plain(*args), 1)
            kernel_cmp_ms = cuda_ms(lambda: kernel(*args), 5)

    launch_ms, bounds, live_lanes, tests = [], [], [], [0, 0]
    flop_prim = FLOP_TRI if prim == "triangle" else FLOP_SPHERE
    for ln in launches:
        args = (ln["o"], ln["d"], ln["max_t"], ln["bvh"], prim, ln["tables"],
                mode, ln["k"])
        n = ln["o"].shape[0]
        launch_ms.append(cuda_ms(lambda: kernel(*args), 3))
        counters = torch.zeros((n, 2), dtype=torch.int32,
                               device=ln["o"].device)
        kernel(*args, counters=counters)
        tot = counters.sum(0, dtype=torch.int64).tolist()
        tests[0] += tot[0]
        tests[1] += tot[1]
        ops = FLOP_BOX * tot[0] + flop_prim * tot[1]
        bounds.append((lbvh_bytes(ln) / PEAK_BYTES_S * 1e3,
                       ops / PEAK_F32_S * 1e3))
        live_lanes.append(int((ln["max_t"] > 0).sum()))
    t_bytes, t_ops = bounds[0]
    pack_ms = lbvh_pack_ms(first["bvh"], prim, first["tables"])
    ok = hit_mm == 0 and ref_mm == 0 and max_rel <= T_RTOL
    vkey = tt.leaf_variant_key(key, gen)
    log(f"kernel {name} [{vkey}, traverse_lbvh.cu]: compared launches "
        f"{compared} lanes={n_lanes} live={n_live} plain_hits={n_hits} "
        f"hit_mismatch={hit_mm} ref_mismatch={ref_mm} max_rel_t="
        f"{max_rel:.3e} kernel_ms_compare={kernel_cmp_ms:.4f} plain_ms="
        f"{plain_ms:.3f} | first launch lanes={first['o'].shape[0]} live="
        f"{live_lanes[0]} ms={launch_ms[0]:.4f} bound_ms="
        f"{max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) | "
        f"{len(launches)} launches: ms_sum={sum(launch_ms):.4f} "
        f"bound_ms_sum={sum(max(b) for b in bounds):.4f} box_tests="
        f"{tests[0]} prim_tests={tests[1]} lbvh_pack_ms={pack_ms:.4f} "
        f"{'OK' if ok else 'FAIL'}")
    if len(launches) > 1:
        log(f"  launch ms {[round(t, 4) for t in launch_ms]} live lanes "
            f"{live_lanes}")
    return ok, {
        "name": name, "route": "cuda", "source": LBVH_SOURCE,
        "entry": LBVH_ENTRY, "replaces": LBVH_REPLACES, "mode_key": key,
        "variant": vkey, "launches": count.get(key, 0),
        "max_abs_err": max_abs, "ms": launch_ms[0], "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "lanes": first["o"].shape[0],
        "ms_frame": sum(launch_ms),
        "bound_ms_frame": sum(max(b) for b in bounds),
        "launch_ms": launch_ms, "launch_live_lanes": live_lanes,
        "compared_launches": compared, "compare_lanes": n_lanes,
        "kernel_ms_compare": kernel_cmp_ms, "hit_mismatch": hit_mm,
        "ref_mismatch": ref_mm, "max_rel_t": max_rel,
        "box_tests": tests[0], "prim_tests": tests[1],
        "lbvh_pack_ms": pack_ms, "redesigned": 12,
        "launches_training_step": 0,
    }


def lbvh_frame_phase(label, frame, expect, entries, exact=True):
    """A timed frame on a flat BVH (timed_frames with the LBVH recorder):
    its launches by mode (``expect``: mode -> count, or -> None for "at
    least one"), all on traverse_lbvh.cu, the image finite and mostly
    hit, every mode held against the plain version."""
    rec, launches, warm_s, times, color, depth = timed_frames(frame,
                                                              lbvh=True)
    frame_s = sum(times) / len(times)
    finite = bool(torch.isfinite(color).all())
    hit = float((depth > 0).float().mean())
    std = float(color[:, :3].std())
    n = sum(launches.values())
    ok = (finite and std > 0 and hit > 0.5
          and rec.entries[LBVH_ENTRY] == n > 0
          and all((launches[k] == c) if c is not None else launches[k] > 0
                  for k, c in expect.items())
          and (not exact or n == sum(launches[k] for k in expect)))
    log(f"{label} 1920x1080: frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches={ {k: v for k, v in launches.items() if v} } "
        f"variants={rec.variants} entry_launches={rec.entries} "
        f"hit_fraction={hit:.4f} image_mean="
        f"{float(color[:, :3].mean()):.6f} image_std={std:.6f} "
        f"finite={finite} {'OK' if ok else 'FAIL'}")
    slug = label.replace(" ", "_")
    for key, lns in rec.launches.items():
        good, entry = check_lbvh_mode(key, f"traverse_{key}_{slug}", lns,
                                      launches)
        entry["phase"] = label
        entries.append(entry)
        ok &= good
    return ok, dict(frame_s=frame_s, frame_times=times, warm_s=warm_s,
                    launches={k: v for k, v in launches.items() if v},
                    variants=rec.variants), color, depth


def lbvh_phase(cpu_mesh, dev, entries):
    """Phase 14: the LBVH of the 260k scene, its frames, step and queries."""
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        scene, cam = sponza_like_scene(target_tris=TARGET_TRIS, device=dev)
    torch.cuda.synchronize()
    out["lbvh_scene_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        again = build_lbvh(scene.mesh)
    torch.cuda.synchronize()
    out["lbvh_build_s"] = time.perf_counter() - t0
    bvh = scene.bvh
    out["lbvh_pack_ms"] = lbvh_pack_ms(
        bvh, "triangle", tt.prim_tables("triangle", scene.mesh))
    cpu = build_lbvh(cpu_mesh)
    fields = ("node_lo", "node_hi", "left", "right", "parent", "prim_ids")
    same = (all(torch.equal(getattr(bvh, f).cpu(), getattr(cpu, f))
                and torch.equal(getattr(again, f), getattr(bvh, f))
                for f in fields) and bvh.depth == cpu.depth)
    out.update(lbvh_depth=bvh.depth, lbvh_nodes=bvh.num_nodes,
               lbvh_sah_cost=sah_cost(bvh))
    log(f"LBVH (sponza_like_scene default): tris={scene.num_triangles} "
        f"lbvh_scene_s={out['lbvh_scene_s']:.3f} lbvh_build_s="
        f"{out['lbvh_build_s']:.3f} lbvh_pack_ms={out['lbvh_pack_ms']:.4f} "
        f"nodes={bvh.num_nodes} depth={bvh.depth} "
        f"sah_cost={out['lbvh_sah_cost']:.4f} tables_equal_to_cpu_build="
        f"{same}")
    ok = same and isinstance(bvh, type(cpu))
    del again

    # (a) the simple frame, render's defaults only
    def simple(num):
        rt = render(scene, cam, WIDTH, HEIGHT)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    with torch.no_grad():
        good, out["simple"], _, _ = lbvh_frame_phase(
            "lbvh simple frame", simple, {"lbvh_closest": 1}, entries)
    ok &= good
    out["lbvh_simple_frame_s"] = out["simple"]["frame_s"]

    # (b) the 5-bounce NEE frame of phase 3
    params = KernelParams.create(
        scene, num_bounces=BOUNCES, epsilon=1e-3,
        bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = swizzled_pixels(dev)

    def nee(num):
        return render_pixels(params, cam, x, y, WIDTH, HEIGHT, "pathtracing",
                             SPP, "jittered_blend", num, nee=True)

    with torch.no_grad():
        good, out["frame"], _, _ = lbvh_frame_phase(
            "lbvh nee frame", nee, {"lbvh_closest": BOUNCES,
                                    "lbvh_any": BOUNCES}, entries)
    ok &= good
    out["lbvh_frame_s"] = out["frame"]["frame_s"]

    # (f) the bounce's two kernels in (b)'s frame
    with torch.no_grad():
        good, out["bounce"] = bounce_phase(params, cam, x, y, entries)
    ok &= good

    # (c) the training step on the LBVH
    with recompute_counted() as recomputed:
        good, out["step"] = training_step_phase(
            params, cam, x, y, label="lbvh training step",
            modes=("lbvh_closest", "lbvh_any"))
    good &= out["step"]["forward_entries"][LBVH_ENTRY] == sum(
        out["step"]["forward_launches"].values())
    # the fused bounce under autograd: the two shading kernels once a
    # bounce in the forward, none in the backward; the backward the
    # adjoint kernel once a bounce, and no bounce of the torch body
    # recomputed in any of the phase's steps
    good &= all(out["step"]["forward_entries"][e] == BOUNCES
                and out["step"]["backward_entries"][e] == 0
                for e in (bs.ENTRY_HIT, bs.ENTRY_CLOSE))
    good &= (out["step"]["forward_entries"][bs.ENTRY_BWD] == 0
             and out["step"]["backward_entries"][bs.ENTRY_BWD] == BOUNCES)
    out["step"]["recomputed_bounces"] = recomputed[0]
    good &= recomputed[0] == 0
    log(f"  lbvh training step backward: {bs.ENTRY_BWD} "
        f"{out['step']['backward_entries'][bs.ENTRY_BWD]} launches (want "
        f"{BOUNCES}), torch-body bounces recomputed {recomputed[0]} (want 0) "
        f"{'OK' if good else 'FAIL'}")
    ok &= good

    # (g) the same step through the torch body
    good, out["step_vs_torch"] = fused_step_phase(params, cam, x, y)
    ok &= good
    out["lbvh_step_s"] = out["step"]["step_s"]
    for e in entries:
        if e.get("phase") == "lbvh nee frame":
            e["launches_training_step"] = \
                out["step"]["forward_launches"].get(e["mode_key"], 0)
        if e.get("phase") == "lbvh bounce kernels":
            e["launches_training_step"] = \
                out["step"]["forward_entries"].get(e["entry"], 0)

    with torch.no_grad():
        # (d) multi_hit on the primary rays
        px, py = _pixel_grid(WIDTH, HEIGHT, dev)
        ray = cam.primary_rays(px, py, WIDTH, HEIGHT)
        ref = closest_hit(ray, scene)
        mrec = BvhRecorder(tt.bvh_traverse)
        with bvh_recorded(mrec):
            multi_hit(ray, scene, k=MULTI_HIT_K)
            torch.cuda.synchronize()
        trav.reset_launch_counts()
        mtimes = []
        for i in range(TIMED_FRAMES):
            t0 = time.perf_counter()
            mh = multi_hit(ray, scene, k=MULTI_HIT_K)
            torch.cuda.synchronize()
            mtimes.append(time.perf_counter() - t0)
            if i == 0:
                mlaunches = dict(trav.LAUNCHES)
        h0 = mh.hit[:, 0]
        sorted_k = bool((mh.t[:, 1:] >= mh.t[:, :-1]).all())
        slot0 = (torch.equal(h0, ref.hit)
                 and torch.equal(mh.prim_id[h0, 0], ref.prim_id[h0])
                 and torch.equal(mh.t[h0, 0], ref.t[h0]))
        hist = torch.bincount(mh.hit.sum(1), minlength=MULTI_HIT_K + 1)
        out["lbvh_multi_hit_s"] = sum(mtimes) / len(mtimes)
        good = (sorted_k and slot0
                and mlaunches["lbvh_multi"] == 1
                and sum(mlaunches.values()) == 1)
        log(f"lbvh multi_hit 1920x1080 primary rays k={MULTI_HIT_K}: "
            f"lbvh_multi_hit_s={out['lbvh_multi_hit_s']:.4f} (calls "
            f"{', '.join(f'{t:.4f}' for t in mtimes)}) launches="
            f"{ {k: v for k, v in mlaunches.items() if v} } t sorted along "
            f"k={sorted_k} slot 0 = closest hit (prim, t bit-equal)={slot0} "
            f"lanes by hits "
            f"found={hist.tolist()} {'OK' if good else 'FAIL'}")
        for key, lns in mrec.launches.items():
            g, entry = check_lbvh_mode(key, "traverse_lbvh_multi_k16", lns,
                                       mlaunches)
            entry["phase"] = "lbvh multi_hit"
            entries.append(entry)
            good &= g
        ok &= good
        del mrec

        # (e) the simple frame through the prim % 7 filter
        def filtered(num):
            rt = render(scene, cam, WIDTH, HEIGHT, hit_filter=reject_mod7)
            return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

        good, out["filtered"], _, _ = lbvh_frame_phase(
            "lbvh filtered frame", filtered, {"lbvh_closest": None}, entries)
        n = out["filtered"]["launches"].get("lbvh_closest", 0)
        got = closest_hit(ray, scene, hit_filter=reject_mod7)
        kept_rejected = int((got.hit & (got.prim_id % 7 == 0)).sum())
        acc = ref.hit & (ref.prim_id % 7 != 0)
        same = (bool(got.hit[acc].all())
                and torch.equal(got.prim_id[acc], ref.prim_id[acc])
                and torch.equal(got.t[acc], ref.t[acc]))
        good &= 1 <= n <= 16 and kept_rejected == 0 and same
        log(f"  lbvh filtered: re-trace launches={n} accepted prims the "
            f"filter rejects={kept_rejected} accepted winners same prim and "
            f"t={same} {'OK' if good else 'FAIL'}")
        ok &= good
        out["lbvh_filtered_frame_s"] = out["filtered"]["frame_s"]
    return ok, out, scene, cam


class BounceRecorder:
    """Stands in for ops/bounce_shade.py's shade_hit and shade_close during
    one frame and keeps the inputs and outputs of every launch, in launch
    order (the frame writes none of them in place)."""

    def __init__(self):
        self.hit_fn, self.close_fn = bs.shade_hit, bs.shade_close
        self.hit, self.close = [], []

    def shade_hit(self, *args):
        out = self.hit_fn(*args)
        self.hit.append((args, out))
        return out

    def shade_close(self, *args):
        out = self.close_fn(*args)
        self.close.append((args, out))
        return out


@contextlib.contextmanager
def bounce_recorded(rec):
    """shade_hit and shade_close replaced by the BounceRecorder ``rec``."""
    bs.shade_hit, bs.shade_close = rec.shade_hit, rec.shade_close
    try:
        yield rec
    finally:
        bs.shade_hit, bs.shade_close = rec.hit_fn, rec.close_fn


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bounce_bytes(hargs, hk, cargs, ck):
    """Bytes each kernel of one bounce must move, and the lanes whose
    closest walk hit.  Lane arrays read for every lane count every lane;
    what a kernel reads for some lanes only counts those: the triangle's
    record (48 B), prim id, face normal, material id (and corner normals)
    gathered where the walk's ref >= 0 (a lane without a hit reads row 0,
    which stays in cache), the shadow ref where the lane fired, the
    previous bounce's delta flag where an active lane is emissive.  The
    material and light tables once."""
    sh, o, d, ref, state, active, dst, acc, _ = hargs
    _, _, hit, sref, dst2, acc2, prev, bounce = cargs
    n = o.shape[0]
    hits = int((ref >= 0).sum())
    row = 4 + 48 + 4 + 12 + (0 if sh.scene.mesh.face_normals_binding else 36)
    tables = _nbytes(sh.mat, sh.lights, sh.amb, sh.eps)
    hit_b = (_nbytes(o, d, ref, state, active, dst, acc if sh.nee else None)
             + hits * row + tables
             + _nbytes(hk.state, hk.carry, hk.first_hit, hk.first_t,
                       hk.shadow_o, hk.shadow_d, hk.shadow_t, hk.fire,
                       hk.mid))
    flags = hit.mid[bs.MID_FLAGS].view(torch.int32)
    lit = sh.nee and sh.total > 0
    rows = bs.MID if lit else bs.MID - 6
    fired = int(((flags & bs.FIRE) != 0).sum()) if lit else 0
    emis = int((((flags & bs.ACTIVE) != 0)
                & ((flags & bs.EMISSIVE) != 0)).sum())
    close_b = (rows * 4 * n + (12 * n if lit else 0) + 4 * fired
               + _nbytes(dst2, acc2)
               + (emis if sh.nee and bounce > 0 else 0)
               + _nbytes(sh.mat, sh.eps)
               + _nbytes(ck.o, ck.d, ck.max_t, ck.dst, ck.acc, ck.active,
                         ck.prev_delta))
    return hit_b, close_b, hits


def _outputs_differ(pairs):
    """(lanes that differ, largest difference) over (kernel, plain) output
    pairs; NaN equals NaN, -0 equals 0; int32-bit rows as integers."""
    lanes, big = 0, 0.0
    for a, p in pairs:
        if a is None or p is None:
            lanes += int((a is None) != (p is None))
            continue
        if a.dtype != torch.float32:
            ne = a != p
        else:
            ne = (a != p) & ~(torch.isnan(a) & torch.isnan(p))
            if bool(ne.any()):
                big = max(big, float((a - p).abs()[ne].max()))
        lanes += int(ne.reshape(ne.shape[0], -1).any(-1).sum())
    return lanes, big


@contextlib.contextmanager
def recompute_counted():
    """kernels/pathtracing.py's ``_recompute`` (the context of a bounce of
    the torch body recomputed in a backward) counting its entries into
    the yielded one-item list."""
    count, was = [0], pt._recompute

    def counting(tape):
        count[0] += 1
        return was(tape)

    pt._recompute = counting
    try:
        yield count
    finally:
        pt._recompute = was


def fused_step_phase(params, cam, x, y):
    """Phase 14g: the full-width training step of (c) through the fused
    bounce, ``pathtracing_kernel``'s pick under autograd, and through the
    torch body (``_torch_body`` in render's kernel table), on the same
    inputs and draws: the fused step launches each shading kernel and the
    adjoint kernel once a bounce, and its loss and gradients are within
    sponza_lbvh.train's
    limits of ``correct`` of the torch body's (STEP_GAPS; relative, the
    gradients by L2 norm, as benchmark/harness/check.py reads them)."""
    verts, cd = params.scene.mesh.vertices, params.scene.materials.cd
    entries = (bs.ENTRY_HIT, bs.ENTRY_CLOSE, bs.ENTRY_BWD)
    trav.reset_launch_counts()
    loss, (gv, gc) = step.loss_and_grads(verts, cd, 6, params, cam, x, y,
                                         nee=True)
    torch.cuda.synchronize()
    launches = {e: trav.ENTRY_LAUNCHES[e] for e in entries}
    was = srender.KERNELS["pathtracing"]
    srender.KERNELS["pathtracing"] = pt._torch_body
    try:
        trav.reset_launch_counts()
        body, (bv, bc) = step.loss_and_grads(verts, cd, 6, params, cam, x,
                                             y, nee=True)
        torch.cuda.synchronize()
        body_launches = {e: trav.ENTRY_LAUNCHES[e] for e in entries}
    finally:
        srender.KERNELS["pathtracing"] = was

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm())

    gaps = {"loss_gap": abs(float(loss) - float(body)) / abs(float(body)),
            "gv_gap": rel(gv, bv), "gcd_gap": rel(gc, bc)}
    same = bool(torch.equal(loss, body))
    ok = (all(c == BOUNCES for c in launches.values())
          and not any(body_launches.values())
          and all(gaps[k] <= lim for k, lim in STEP_GAPS.items()))
    log(f"lbvh training step, fused against the torch body "
        f"{WIDTH}x{HEIGHT} nee: loss {float(loss):.9g} / {float(body):.9g} "
        f"(bit-equal={same}) "
        + " ".join(f"{k}={v:.3e} (limit {STEP_GAPS[k]})"
                   for k, v in gaps.items())
        + f" shading launches {launches} (want {BOUNCES} each), through "
        f"the torch body {body_launches} {'OK' if ok else 'FAIL'}")
    return ok, dict(gaps, loss_bit_equal=same, shading_launches=launches)


def bounce_phase(params, cam, x, y, entries):
    """Phase 14f: the bounce's two kernels in phase 14b's NEE frame."""
    rec = BounceRecorder()
    walks = ("lbvh_closest", "lbvh_any")
    trav.reset_launch_counts()
    with bounce_recorded(rec):
        render_pixels(params, cam, x, y, WIDTH, HEIGHT, "pathtracing", SPP,
                      "jittered_blend", 7, nee=True)
        torch.cuda.synchronize()
    counts = {e: trav.ENTRY_LAUNCHES[e] for e in (bs.ENTRY_HIT,
                                                  bs.ENTRY_CLOSE)}
    wcounts = {k: trav.LAUNCHES[k] for k in walks}
    ok = (all(c == BOUNCES for c in counts.values())
          and all(c == BOUNCES for c in wcounts.values())
          and len(rec.hit) == len(rec.close) == BOUNCES)
    log(f"lbvh bounce kernels, the NEE frame {WIDTH}x{HEIGHT}: launches "
        f"{counts} "
        f"walks {wcounts} (want {BOUNCES} each) {'OK' if ok else 'FAIL'}")

    hit_fields = ("state", "carry", "first_hit", "first_t", "shadow_o",
                  "shadow_d", "shadow_t", "fire")
    close_fields = ("o", "d", "max_t", "dst", "acc", "active", "prev_delta")
    res = {k: [] for k in ("hit_ms", "close_ms", "hit_plain_ms",
                           "close_plain_ms", "hit_bytes", "close_bytes",
                           "hit_lanes", "live_lanes", "hit_diff",
                           "close_diff", "hit_max", "close_max")}
    for (hargs, hk), (cargs, ck) in zip(rec.hit, rec.close):
        # the frame's own outputs against the plain versions on its inputs
        hp = bs.shade_hit_plain(*hargs)
        cp = bs.shade_close_plain(*cargs)
        lanes, big = _outputs_differ(
            [(getattr(hk, f), getattr(hp, f)) for f in hit_fields]
            + [(hk.mid[r], hp.mid[r]) for r in range(bs.MID)])
        res["hit_diff"].append(lanes)
        res["hit_max"].append(big)
        lanes, big = _outputs_differ(
            [(getattr(ck, f), getattr(cp, f)) for f in close_fields])
        res["close_diff"].append(lanes)
        res["close_max"].append(big)
        del hp, cp
        res["hit_ms"].append(cuda_ms(lambda: bs.shade_hit(*hargs), 10))
        res["close_ms"].append(cuda_ms(lambda: bs.shade_close(*cargs), 10))
        res["hit_plain_ms"].append(
            cuda_ms(lambda: bs.shade_hit_plain(*hargs), 1))
        res["close_plain_ms"].append(
            cuda_ms(lambda: bs.shade_close_plain(*cargs), 1))
        hb, cb, hits = bounce_bytes(hargs, hk, cargs, ck)
        res["hit_bytes"].append(hb)
        res["close_bytes"].append(cb)
        res["hit_lanes"].append(hits)
        res["live_lanes"].append(int(hargs[5].sum()))
    n = rec.hit[0][0][1].shape[0]
    good = (sum(res["hit_diff"]) == 0 and sum(res["close_diff"]) == 0)
    ok &= good
    log(f"  per bounce, the frame's launches against the plain versions: "
        f"hit kernel lanes differing {res['hit_diff']} (largest "
        f"{max(res['hit_max']):.3g}), close kernel {res['close_diff']} "
        f"(largest {max(res['close_max']):.3g}) {'OK' if good else 'FAIL'}")
    del rec

    # the fused frame against the torch body on the same rays and draws
    ray = cam.primary_rays(x, y, WIDTH, HEIGHT, None)
    samp = Sampler.seed(5, (y * WIDTH + x).to(torch.int64), 2)
    fused = pt.pathtracing_kernel(params, ray, samp, nee=True)
    body = pt._torch_body(params, ray, samp, nee=True)
    diff = (fused.color - body.color).abs()
    off = float((diff > FUSED_PIX_TOL).any(-1).float().mean())
    unequal = int((fused.color != body.color).any(-1).sum())
    same = (torch.equal(fused.hit, body.hit)
            and torch.equal(fused.depth, body.depth))
    good = pt._fused_ok(params) and off <= FUSED_PIX_SHARE and same
    ok &= good
    log(f"  the fused frame against the torch body: pix_off={off:.3e} "
        f"(limit {FUSED_PIX_SHARE}) pixels not bit-equal={unequal} of "
        f"{diff.shape[0]} largest={float(diff.max()):.3e} hit and depth "
        f"equal={same} {'OK' if good else 'FAIL'}")
    del fused, body, diff

    out = dict(bounce_launches=counts, bounce_walk_launches=wcounts,
               fused_pix_off=off, fused_unequal_pixels=unequal)
    for kind, entry in (("hit", bs.ENTRY_HIT), ("close", bs.ENTRY_CLOSE)):
        ms, plain = res[f"{kind}_ms"], res[f"{kind}_plain_ms"]
        bound = [b / PEAK_BYTES_S * 1e3 for b in res[f"{kind}_bytes"]]
        log(f"kernel bounce_shade_{kind} [{entry}, bounce_shade.cu]: "
            f"lanes={n} ms a launch {[round(t, 4) for t in ms]} frame="
            f"{sum(ms):.4f} bound_ms {[round(t, 4) for t in bound]} frame="
            f"{sum(bound):.4f} ({100 * sum(bound) / sum(ms):.1f}% of it) "
            f"plain_ms frame={sum(plain):.3f} hit lanes {res['hit_lanes']}")
        entries.append({
            "name": f"bounce_shade_{kind}", "route": "cuda",
            "source": BOUNCE_SOURCE, "entry": entry,
            "replaces": BOUNCE_REPLACES, "launches": counts[entry],
            "max_abs_err": max(res[f"{kind}_max"]), "ms": ms[0],
            "plain_ms": plain[0], "bound_ms": bound[0], "bound_by": "bytes",
            "library_ms": None, "lanes": n, "ms_frame": sum(ms),
            "bound_ms_frame": sum(bound), "plain_ms_frame": sum(plain),
            "launch_ms": ms, "launch_plain_ms": plain,
            "launch_bound_ms": bound, "launch_bytes": res[f"{kind}_bytes"],
            "launch_hit_lanes": res["hit_lanes"],
            "launch_live_lanes": res["live_lanes"],
            "lanes_differing": res[f"{kind}_diff"],
            "phase": "lbvh bounce kernels", "launches_training_step": 0})
    return ok, out


def builders_phase(scene, cam, entries):
    """Phase 15: the native SAH and SBVH builds of the mesh and the simple
    frame on each.  The builders' library is compiled (g++, at first use)
    before the builds are timed."""
    t0 = time.perf_counter()
    ok = sah.available()
    out = {"sah_library_s": time.perf_counter() - t0}
    log(f"native SAH/SBVH library: sah_library_s={out['sah_library_s']:.3f} "
        f"available={ok} -> {sah.library_path()}")
    for name in ("sah", "sbvh"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bvh = getattr(sah, f"build_{name}")(scene.mesh)
        torch.cuda.synchronize()
        out[f"{name}_build_s"] = time.perf_counter() - t0
        out[f"{name}_sah_cost"] = sah_cost(bvh)
        out[f"{name}_depth"] = bvh.depth
        gen = bvh.leaf_first is not None
        log(f"{name} build (host, native): {name}_build_s="
            f"{out[f'{name}_build_s']:.3f} nodes={bvh.num_nodes} refs="
            f"{bvh.num_prims} depth={bvh.depth} sah_cost="
            f"{out[f'{name}_sah_cost']:.4f} generalized_leaves={gen}")
        s2 = dataclasses.replace(scene, bvh=bvh)

        def frame(num, s2=s2):
            rt = render(s2, cam, WIDTH, HEIGHT)
            return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

        with torch.no_grad():
            good, info, _, _ = lbvh_frame_phase(
                f"{name} simple frame", frame, {"lbvh_closest": 1}, entries)
        good &= set(info["variants"]) == {
            tt.leaf_variant_key("lbvh_closest", gen)}
        ok &= good
        out[f"{name}_simple_frame_s"] = info["frame_s"]
        out[f"{name}_simple_frame"] = info
    return ok, out


def sphere_scene(dev):
    """Phase 16's field: SPHERE_COUNT spheres in a 40-unit cube, radii
    log-uniform in [0.01, 0.5] and 1% at 1e-9, over a plane, one point
    light, camera outside the cube."""
    rng = np.random.default_rng(16)
    n = SPHERE_COUNT
    center = rng.uniform(-20.0, 20.0, (n, 3)).astype(np.float32)
    radius = np.exp(rng.uniform(np.log(0.01), np.log(0.5), n)).astype(
        np.float32)
    radius[rng.choice(n, n // 100, replace=False)] = 1e-9
    spheres = Spheres.create(center, radius,
                             geom_ids=rng.integers(0, 3, n), device=dev)
    planes = Planes.create([[0.0, 1.0, 0.0]], [-21.0], geom_ids=[3],
                           device=dev)
    materials = Materials.concatenate([
        Materials.plastic(cd=(0.8, 0.3, 0.2), specular_exp=32.0,
                          device=dev),
        Materials.matte(cd=(0.3, 0.7, 0.4), device=dev),
        Materials.mirror(cr=(0.9, 0.9, 0.9), device=dev),
        Materials.matte(cd=(0.7, 0.7, 0.7), device=dev)])
    t0 = time.perf_counter()
    sbvh = tt.build_sphere_bvh(spheres)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    scene = Scene.create(spheres=spheres, planes=planes, materials=materials,
                         lights=PointLights.create((10.0, 40.0, 30.0),
                                                   device=dev),
                         sphere_bvh=sbvh, device=dev)
    cam = Pinhole.create(eye=(0.0, 5.0, 62.0), center=(0.0, -2.0, 0.0),
                         fovy=np.deg2rad(45.0), aspect=16.0 / 9.0,
                         device=dev)
    return scene, cam, build_s


def sphere_phase(dev, entries):
    """Phase 16: the Whitted frame over the sphere field's BVH."""
    scene, cam, build_s = sphere_scene(dev)
    bvh = scene.sphere_bvh
    log(f"sphere BVH: spheres={scene.num_spheres} sphere_bvh_build_s="
        f"{build_s:.3f} nodes={bvh.num_nodes} depth={bvh.depth}")

    def frame(num):
        rt = render(scene, cam, WIDTH, HEIGHT, algo="whitted")
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    with torch.no_grad():
        ok, info, _, _ = lbvh_frame_phase(
            "sphere whitted frame", frame, {"sphere_closest": None,
                                            "sphere_any": None}, entries)
    return ok, dict(sphere_frame_s=info["frame_s"],
                    sphere_bvh_build_s=build_s, sphere_frame=info)


def textured_scene(dev):
    """Phase 17's scene: sponza_like_scene(260_000) on its default LBVH,
    per-corner UVs from a planar projection of the vertices (numpy, seed
    17) and one procedural TEX_RES^2 image per material, a checker plus
    noise.  Returns (scene without textures, camera, images)."""
    scene, cam = sponza_like_scene(target_tris=TARGET_TRIS, device=dev)
    rng = np.random.default_rng(17)
    verts = scene.mesh.vertices.cpu().numpy()
    faces = scene.mesh.faces.cpu().numpy()
    proj = (0.25 * rng.standard_normal((3, 2))).astype(np.float32)
    uv = (verts @ proj)[faces]                          # (F, 3, 2)
    yy, xx = np.meshgrid(np.arange(TEX_RES), np.arange(TEX_RES),
                         indexing="ij")
    images = {}
    for m in range(scene.materials.mtype.shape[0]):
        tiles = 4 + 2 * m
        check = ((xx * tiles // TEX_RES) + (yy * tiles // TEX_RES)) % 2
        base = rng.uniform(0.3, 1.0, 3).astype(np.float32)
        img = np.where(check[..., None] == 0, base, 1.0 - 0.7 * base)
        img = img + 0.1 * rng.standard_normal(img.shape)
        images[m] = np.clip(img, 0.0, 1.0).astype(np.float32)
    mesh = dataclasses.replace(scene.mesh, tex_coords=torch.as_tensor(
        uv, dtype=torch.float32, device=dev))
    return dataclasses.replace(scene, mesh=mesh), cam, images


def simple_frame(scene, cam):
    def frame(num):
        rt = render(scene, cam, WIDTH, HEIGHT)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)
    return frame


def texture_phase(dev, entries):
    """Phase 17: textures on the LBVH of the 260k scene."""
    out = {}
    base, cam, images = textured_scene(dev)
    M = base.materials.mtype.shape[0]

    def pack(filt, mode, imgs=images):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atlas = TextureAtlas.pack(imgs, M, resolution=TEX_RES, filter=filt,
                                  address_mode=mode, device=dev)
        torch.cuda.synchronize()
        return atlas, time.perf_counter() - t0

    atlas, out["tex_pack_s"] = pack(Filter.LINEAR, AddressMode.WRAP)
    scene = dataclasses.replace(base, textures=atlas)
    log(f"textured scene: tris={scene.num_triangles} materials={M} atlas="
        f"{tuple(atlas.texels.shape)} LINEAR/WRAP tex_pack_s="
        f"{out['tex_pack_s']:.3f}")

    # (a) the simple frame, render's defaults
    good, out["simple"], color, _ = lbvh_frame_phase(
        "tex simple frame", simple_frame(scene, cam), {"lbvh_closest": 1},
        entries)
    out["tex_simple_frame_s"] = out["simple"]["frame_s"]
    plain = simple_frame(base, cam)(1)[0]
    white, _ = pack(Filter.NEAREST, AddressMode.WRAP,
                    {m: np.ones((4, 4, 3), np.float32) for m in range(M)})
    white_img = simple_frame(dataclasses.replace(base, textures=white),
                             cam)(1)[0]
    white_same = torch.equal(white_img, plain)
    differs = float((color - plain).abs().max())
    good &= white_same and differs > 0.05
    log(f"  an all-white enabled atlas (NEAREST) gives the untextured frame "
        f"bit for bit={white_same}; textured vs untextured max abs="
        f"{differs:.4f} {'OK' if good else 'FAIL'}")
    ok = good

    # (b) the 5-bounce NEE frame of phase 14b
    params = KernelParams.create(
        scene, num_bounces=BOUNCES, epsilon=1e-3,
        bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = swizzled_pixels(dev)

    def nee(num):
        return render_pixels(params, cam, x, y, WIDTH, HEIGHT, "pathtracing",
                             SPP, "jittered_blend", num, nee=True)

    good, out["frame"], _, _ = lbvh_frame_phase(
        "tex nee frame", nee, {"lbvh_closest": BOUNCES,
                               "lbvh_any": BOUNCES}, entries)
    ok &= good
    out["tex_frame_s"] = out["frame"]["frame_s"]

    # (c) the simple frame under the other filters and address modes
    for name, filt, mode in TEX_VARIANTS:
        atlas_v, pack_s = pack(filt, mode)
        if filt == Filter.BSPLINE_INTERPOL:
            out["tex_prefilter_s"] = pack_s
        _, launches, _, times, c, _ = timed_frames(
            simple_frame(dataclasses.replace(base, textures=atlas_v), cam),
            lbvh=True)
        frame_s = sum(times) / len(times)
        good = (bool(torch.isfinite(c).all())
                and launches["lbvh_closest"] == 1
                and sum(launches.values()) == 1
                and float((c - plain).abs().max()) > 0.05)
        out[f"tex_simple_{name}_frame_s"] = frame_s
        log(f"tex simple frame {name} ({filt.name}/{mode.name}): frame_s="
            f"{frame_s:.4f} pack_s={pack_s:.3f} launches="
            f"{ {k: v for k, v in launches.items() if v} } image_mean="
            f"{float(c[:, :3].mean()):.6f} {'OK' if good else 'FAIL'}")
        ok &= good
    return ok, out, scene, cam, params, x, y


def tiled_frame(params, cam, x, y, tile):
    """The frame of render_pixels over (x, y) in tiles of ``tile`` lanes."""
    def frame(num):
        parts = [render_pixels(params, cam, x[i:i + tile], y[i:i + tile],
                               WIDTH, HEIGHT, "pathtracing", SPP,
                               "jittered_blend", num, nee=True)
                 for i in range(0, x.shape[0], tile)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return frame


def peak_of(run):
    """Peak device memory (bytes) of run()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), out


def spectral_phase(scene, cam, params, x, y, rgb_color, dev, entries,
                   check_modes):
    """Phase 18: the spectral Cornell box on its LBVH, and the main path's
    frame with spectral=300 in tiles."""
    out = {}
    # (a) cornell_box_spectral() (60 samples), render's pathtracing defaults
    cs, ccam = cornell_box_spectral(device=dev)
    cs.bvh = build_lbvh(cs.mesh)

    def cornell(num):
        rt = render(cs, ccam, WIDTH, HEIGHT, algo="pathtracing",
                    frame_num=num)
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    peak, (ok, info, ccolor, _) = peak_of(lambda: lbvh_frame_phase(
        "spectral cornell frame", cornell, {"lbvh_closest": 10}, entries))
    non_black = float(ccolor[:, :3].mean()) > 0.01
    ok &= non_black
    out.update(spectral_cornell_frame_s=info["frame_s"],
               spectral_cornell_peak_bytes=peak, spectral_cornell=info)
    log(f"  spectral cornell: samples={cs.materials.cd.shape[-1]} "
        f"peak_bytes={peak} non_black={non_black} "
        f"{'OK' if ok else 'FAIL'}")

    # the fold: to_rgb of an SPD block on the card against the CPU's
    rng = np.random.default_rng(18)
    spd = torch.as_tensor(rng.uniform(0, 2, (4096, SPECTRAL_N)),
                          dtype=torch.float32)
    fold_card = to_rgb(spd.to(dev)).cpu()
    fold_cpu = to_rgb(spd)
    fold_err = float(((fold_card - fold_cpu).abs()
                      / fold_cpu.abs().clamp_min(1e-3)).max())
    good = fold_err <= 1e-5
    log(f"to_rgb fold of {SPECTRAL_N}-sample SPDs, card vs CPU: max rel "
        f"err={fold_err:.3e} {'OK' if good else 'FAIL'}")
    ok &= good

    # (b) the main path's frame (treelet ClusterBVH, 5-bounce NEE) with
    # spectral=300, in tiles: the largest of 524288 / 2^k lanes whose peak
    # stays under SPECTRAL_PEAK
    sparams = dataclasses.replace(params, scene=lift_scene(scene,
                                                           SPECTRAL_N))
    tile = SPECTRAL_TILE
    while True:
        peak, _ = peak_of(lambda: tiled_frame(sparams, cam, x, y, tile)(1))
        if peak < SPECTRAL_PEAK or tile <= 65536:
            break
        log(f"  spectral frame: tile {tile} peaks at {peak} bytes; halving")
        tile //= 2
    frame = tiled_frame(sparams, cam, x, y, tile)
    rec, launches, warm_s, times, color, depth = timed_frames(frame)
    frame_s = sum(times) / len(times)
    n_tiles = -(-x.shape[0] // tile)
    finite = bool(torch.isfinite(color).all())
    mean = color[:, :3].mean(0)
    rgb_mean = rgb_color[:, :3].mean(0)
    good = (finite and float(mean.min()) > 0.01 and peak < SPECTRAL_PEAK
            and all(launches[k] > 0 for k, _, _ in MODES))
    log(f"spectral frame 1920x1080 spp=1 bounces=5 nee spectral="
        f"{SPECTRAL_N}: spectral_frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"tile={tile} tiles={n_tiles} peak_bytes={peak} launches="
        f"{ {k: v for k, v in launches.items() if v} } entry_launches="
        f"{rec.entries} image_mean_rgb={[round(float(v), 6) for v in mean]}"
        f" (RGB frame {[round(float(v), 6) for v in rgb_mean]}) "
        f"finite={finite} {'OK' if good else 'FAIL'}")
    ok &= good
    first = len(entries)
    ok &= check_modes([(k, f"{name}_spectral{SPECTRAL_N}", row)
                       for k, name, row in MODES], rec, scene.bvh, launches)
    for e in entries[first:]:
        e["phase"] = "spectral frame"
    del rec
    out.update(spectral_frame_s=frame_s, spectral_peak_bytes=peak,
               spectral_tile=tile, spectral_tiles=n_tiles,
               spectral_launches={k: v for k, v in launches.items() if v},
               spectral_frame_times=times)
    return ok, out


def volume_bytes(n, vols):
    """Bytes one march must move: rays in, color, hit and depth out, the
    boxes, texels and transfer tables read once."""
    return (n * 6 * 4 + n * (16 + 1 + 4) + 16 + vols.lo.numel() * 8
            + vols.texels.numel() * 4 + vols.transfer.numel() * 4)


def volume_phase(label, scene, cam, dev, entries, ptx, sass):
    """Phase 19, one scene: render(algo="volume") at 1080p, timed as phase
    3, exactly one vsnray_volume_march launch (its transfer form read from
    VARIANT_LAUNCHES); the launch held against the plain version on
    COMPARE_LANES lanes of its first, middle and last slice; its time
    (CUDA events), steps, empty steps and warp-iterations (the counting
    form), bound, the time to build its tables (volume_pack_ms) and its
    step loop in SASS (``sass``: step_loop of its form); a permuted volume
    array."""
    out = {}
    vols = scene.volumes

    def frame(num):
        rt = render(scene, cam, WIDTH, HEIGHT, algo="volume")
        return rt.color.reshape(-1, 4), rt.depth.reshape(-1)

    # the first frame builds the brick table (one vsnray_volume_bricks
    # launch), the next reuse it
    torch.cuda.synchronize()
    trav.reset_launch_counts()
    t0 = time.perf_counter()
    frame(1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cold = {k: v for k, v in trav.LAUNCHES.items() if v}
    trav.reset_launch_counts()
    t0 = time.perf_counter()
    color, depth = frame(2)
    torch.cuda.synchronize()
    times = [time.perf_counter() - t0]
    launches = dict(trav.LAUNCHES)
    ents = dict(trav.ENTRY_LAUNCHES)
    forms = {k: v for k, v in trav.VARIANT_LAUNCHES.items()
             if k.startswith("volume_march/")}
    for i in range(TIMED_FRAMES - 1):
        t0 = time.perf_counter()
        frame(3 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    frame_s = sum(times) / len(times)
    finite = bool(torch.isfinite(color).all())
    hit = float((depth > 0).float().mean())
    ok = (finite and hit > 0.2 and float(color[:, :3].std()) > 0
          and launches["volume_march"] == 1 and sum(launches.values()) == 1
          and ents[VOLUME_ENTRY] == 1 and sum(forms.values()) == 1
          and cold == {"volume_march": 1, "volume_bricks": 1})
    log(f"{label} 1920x1080 V={vols.num_volumes} "
        f"texels={tuple(vols.texels.shape)}: frame_s={frame_s:.4f} (frames "
        f"{', '.join(f'{t:.4f}' for t in times)}) warm_s={warm_s:.3f} "
        f"launches={ {k: v for k, v in launches.items() if v} } "
        f"(first frame {cold}) forms={forms} "
        f"hit_fraction={hit:.4f} image_mean="
        f"{float(color[:, :3].mean()):.6f} finite={finite} "
        f"{'OK' if ok else 'FAIL'}")

    # the launch itself: the frame's primary rays
    px, py = _pixel_grid(WIDTH, HEIGHT, dev)
    ray = cam.primary_rays(px, py, WIDTH, HEIGHT)
    o, d = ray.ori.contiguous(), ray.dir.contiguous()
    bg = torch.tensor(RENDER_BG, dtype=torch.float32, device=dev)
    n = o.shape[0]
    kc, kh, kd = volume_march(o, d, vols, bg)
    same_frame = torch.equal(kc, color) and torch.equal(
        torch.where(kh, kd, 0.0), depth)
    hit_mm = depth_mm = 0
    max_abs = 0.0
    for s0 in (0, n // 2 - COMPARE_LANES // 2, n - COMPARE_LANES):
        sl = slice(s0, s0 + COMPARE_LANES)
        pc, ph, pd = march_plain(o[sl], d[sl], vols, bg)
        hit_mm += int((kh[sl] != ph).sum())
        depth_mm += int((kd[sl] != pd).sum())
        max_abs = max(max_abs, float((kc[sl] - pc).abs().max()))
    os_, ds_ = o[:COMPARE_LANES], d[:COMPARE_LANES]
    plain_ms = cuda_ms(lambda: march_plain(os_, ds_, vols, bg), 1)
    ms = cuda_ms(lambda: volume_march(o, d, vols, bg), 5)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    empty = torch.zeros(n, dtype=torch.int32, device=dev)
    warps = torch.zeros(2, dtype=torch.int64, device=dev)
    volume_march(o, d, vols, bg, steps=steps, empty=empty, warps=warps)
    total = int(steps.sum(dtype=torch.int64))
    n_empty = int(empty.sum(dtype=torch.int64))
    warp_iters, warp_empty = (int(x) for x in warps)
    full = (WIDTH, HEIGHT, VOLUME_RES, MULTI_RES, MULTI_N) == (
        1920, 1080, 256, 128, 3)
    steps_same = total == VOLUME_STEPS[label] if full else None
    t_bytes = volume_bytes(n, vols) / PEAK_BYTES_S * 1e3
    t_ops = total * FLOP_STEP / PEAK_F32_S * 1e3
    # the tables, built anew: pad, window reductions, prefix counts
    pack_ms = min(cuda_ms(lambda: tvol.build_pack(
        vols.texels, vols.transfer, tvol.BRICK), 1) for _ in range(3))
    # permuted volumes: the same image
    perm = torch.arange(vols.num_volumes - 1, -1, -1, device=dev)
    pvols = Volumes(vols.lo[perm], vols.hi[perm], vols.texels[perm],
                    vols.transfer[perm])
    perm_same = torch.equal(volume_march(o, d, pvols, bg)[0], kc)
    # for reference: one trilinear step of the same lanes through
    # grid_sample (no PyTorch call marches a volume; library_ms is null)
    grid = (2.0 * (o + d) - 1.0).clamp(-1, 1).reshape(1, 1, 1, n, 3)
    tex = vols.texels[:1, None]
    gs_ms = cuda_ms(lambda: torch.nn.functional.grid_sample(
        tex, grid, mode="bilinear", padding_mode="border",
        align_corners=False), 5)
    good = (hit_mm == 0 and depth_mm == 0 and max_abs <= VOLUME_ATOL
            and same_frame and perm_same and steps_same is not False
            and 0 <= warp_empty <= warp_iters)
    shared = int(tvol.transfer_form(vols.num_volumes,
                                    vols.transfer.shape[1]) == "shared")
    form = ptx.get(f"volume count=0 shared={shared}", {})
    loop = sass.get(f"volume count=0 shared={shared}") or {}
    log(f"kernel volume_march [{label}, volume_march.cu]: compared "
        f"{3 * COMPARE_LANES} lanes hit_mismatch={hit_mm} depth_mismatch="
        f"{depth_mm} max_abs_color={max_abs:.3e} "
        f"({'bit-equal' if max_abs == 0.0 else 'not bit-equal'}) launch "
        f"equals the frame={same_frame} permuted volumes same image="
        f"{perm_same} | lanes={n} "
        f"ms={ms:.4f} "
        f"plain_ms({COMPARE_LANES} lanes)={plain_ms:.3f} steps={total} "
        f"(mean {total / n:.1f}, max {int(steps.max())}; earlier designs' "
        f"{VOLUME_STEPS[label]} at full size: "
        f"{STEPS_NOTE[steps_same]}) "
        f"empty_steps={n_empty} ({n_empty / max(total, 1):.4f}) "
        f"warp_iterations={warp_iters} all_empty={warp_empty} "
        f"({warp_empty / max(warp_iters, 1):.4f}) bound_ms="
        f"{max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
        f"volume_pack_ms={pack_ms:.4f} "
        f"grid_sample_step_ms={gs_ms:.4f} registers={form.get('regs')} "
        f"stack={form.get('stack')} spills={form.get('spill')} "
        f"sass_step_loop={loop.get('loop')} (empty path "
        f"{loop.get('empty_path')}, global loads {loop.get('loads')}) "
        f"{'OK' if good else 'FAIL'}")
    ok &= good
    entries.append({
        "name": f"volume_march_{label.replace(' ', '_')}", "route": "cuda",
        "source": VOLUME_SOURCE, "entry": VOLUME_ENTRY,
        "replaces": VOLUME_REPLACES, "mode_key": "volume_march",
        "launches": launches["volume_march"], "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms, "plain_lanes": COMPARE_LANES,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "grid_sample_step_ms": gs_ms, "lanes": n,
        "steps": total, "steps_max": int(steps.max()),
        "empty_steps": n_empty, "empty_share": n_empty / max(total, 1),
        "warp_iterations": warp_iters, "warp_all_empty": warp_empty,
        "warp_all_empty_share": warp_empty / max(warp_iters, 1),
        "forms": forms, "volume_pack_ms": pack_ms, "brick": tvol.BRICK,
        "sass_step_loop": loop.get("loop"),
        "sass_empty_path": loop.get("empty_path"),
        "flop_step": FLOP_STEP, "hit_mismatch": hit_mm,
        "depth_mismatch": depth_mm, "registers": form.get("regs"),
        "stack": form.get("stack"), "spills": form.get("spill"),
        "launches_training_step": 0, "phase": label})
    # the brick table: its kernel against its plain version
    good, bricks = bricks_check(label, vols, cold.get("volume_bricks", 0))
    ok &= good
    entries.append(bricks)
    out.update(frame_s=frame_s, frame_times=times, warm_s=warm_s,
               kernel_ms=ms, plain_ms=plain_ms, steps=total, bound_ms=max(
                   t_bytes, t_ops), hit_fraction=hit, empty_steps=n_empty,
               volume_pack_ms=pack_ms, bricks_ms=bricks["ms"])
    return ok, out


def bricks_check(label, vols, launches):
    """The brick table kernel (vsnray_volume_bricks) against its plain
    version (kernels/volume.py::brick_table, pack_bits) on the card, on
    the scene's texels and transfer; its time beside the plain
    version's and a max pooling of the same windows (the lo and hi it
    takes, for reference: no PyTorch call builds the table)."""
    B = tvol.BRICK
    padded = tvol.pad_texels(vols.texels)
    ktab, kbits = tvol.brick_kernel(padded, vols.transfer, B)
    ptab = tvol.brick_table(vols.texels, vols.transfer, B, padded)
    pbits = tvol.pack_bits(ptab)
    mism = int((ktab != ptab).sum()) + int((kbits != pbits).sum())
    ms = cuda_ms(lambda: tvol.brick_kernel(padded, vols.transfer, B), 5)
    plain_ms = cuda_ms(lambda: tvol.pack_bits(tvol.brick_table(
        vols.texels, vols.transfer, B, padded)), 3)
    pool_ms = cuda_ms(lambda: torch.nn.functional.max_pool3d(
        padded[:, None, 1:, 1:, 1:], B + 1, B, ceil_mode=True), 5)
    n = ktab.numel()
    # the padded texels read once, the prefix counts, the table and its
    # words written; a min and a max of each window's texels
    t_bytes = (padded.numel() * 4 + vols.transfer.shape[0]
               * (vols.transfer.shape[1] + 1) * 8 + n + kbits.numel() * 4
               ) / PEAK_BYTES_S * 1e3
    t_ops = n * 2 * (B + 1) ** 3 / PEAK_F32_S * 1e3
    good = mism == 0 and launches == 1
    log(f"kernel volume_bricks [{label}, volume_march.cu]: bricks={n} "
        f"(B={B}) empty={int(ktab.sum())} mismatches vs plain={mism} "
        f"launches in the first frame={launches} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} max_pool3d_ms={pool_ms:.4f} bound_ms="
        f"{max(t_bytes, t_ops):.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
        f"{'OK' if good else 'FAIL'}")
    return good, {
        "name": f"volume_bricks_{label.replace(' ', '_')}", "route": "cuda",
        "source": VOLUME_SOURCE, "entry": "vsnray_volume_bricks",
        "replaces": VOLUME_REPLACES, "mode_key": "volume_bricks",
        "launches": launches, "max_abs_err": float(mism), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "max_pool3d_ms": pool_ms, "bricks": n,
        "brick": B, "empty_bricks": int(ktab.sum()), "phase": label}


def volume_bwd_bytes(n, vols):
    """Bytes the backward must move: rays, dst and dL/dcolor in, the
    boxes, texels and transfer tables read once, the texel gradient written
    once and one flush of the transfer gradient a block (16 B an f64
    entry).  The kernel's per-step texel atomics are its own traffic, not
    the function's: see volume_atomic_bytes."""
    blocks = min(-(-n // 128), 2048)
    return (n * (6 + 4 + 4) * 4 + 16 + vols.lo.numel() * 8
            + vols.texels.numel() * 4 * 2 + vols.transfer.numel() * 4
            + blocks * vols.transfer.numel() * 16)


def volume_atomic_bytes(steps):
    """The texel atomics the backward kernel issues: 8 read-modify-writes
    of 8 B a step (most of them land in L2)."""
    return steps * 8 * 8


def volume_grad_phase(label, scene, cam, dev, entries, ptx):
    """Phase 20, one scene: the backward kernel against the plain version's
    autograd on phase 19's lanes, then the volume training step at 1080p,
    timed, with its launches, memory and the backward kernel's time."""
    vols = scene.volumes
    px, py = _pixel_grid(WIDTH, HEIGHT, dev)
    ray = cam.primary_rays(px, py, WIDTH, HEIGHT)
    o, d = ray.ori.contiguous(), ray.dir.contiguous()
    n = o.shape[0]
    lanes = torch.cat([torch.arange(s0, s0 + COMPARE_LANES, device=dev)
                       for s0 in (0, n // 2 - COMPARE_LANES // 2,
                                  n - COMPARE_LANES)])
    so, sd = o[lanes], d[lanes]
    rng = np.random.default_rng(20)
    w = torch.as_tensor(rng.uniform(-1.0, 1.0, (lanes.numel(), 4)).astype(
        np.float32), device=dev)
    wd = torch.as_tensor(rng.uniform(-1.0, 1.0, lanes.numel()).astype(
        np.float32), device=dev)
    names = ("texels", "transfer", "o", "d", "lo", "hi")

    def grads(march, wanted):
        """The gradients of the leaves in ``wanted`` and of bg (None for a
        leaf that does not require grad)."""
        leaves = [vols.texels, vols.transfer, so, sd, vols.lo, vols.hi]
        leaves = [x.detach().clone().requires_grad_(k in wanted)
                  for k, x in zip(names, leaves)]
        bg = torch.tensor(RENDER_BG, device=dev, requires_grad=True)
        with torch.enable_grad():
            color, _, depth = march(leaves[2], leaves[3], Volumes(
                lo=leaves[4], hi=leaves[5], texels=leaves[0],
                transfer=leaves[1]), bg)
            ((color * w).sum() + (depth * wd).sum()).backward()
        torch.cuda.synchronize()
        return [x.grad for x in leaves] + [bg.grad]

    def check_form(form, wanted):
        """The kernel form that ``wanted`` launches (volume_bwd_kernel<
        false> for texels and transfer: no ray or box gradient is asked
        of the kernel; <true> with them) against the plain version's
        autograd on the same lanes."""
        trav.reset_launch_counts()
        kg = grads(volume_march, wanted)
        launches = (trav.LAUNCHES["volume_march"],
                    trav.LAUNCHES["volume_march_bwd"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pg = grads(march_plain, wanted)
        plain_s = time.perf_counter() - t0
        stats = {k: grad_stats(a, b) for k, a, b in zip(names, kg, pg)
                 if k in wanted}
        kbg, pbg = kg[-1], pg[-1]
        bg_rel = float((kbg - pbg).abs().max() / pbg.abs().max())
        got = [a for a in kg if a is not None]
        max_abs = max(float((a - b).abs().max()) for a, b in zip(kg, pg)
                      if a is not None)
        # the form: a leaf that requires no grad gets none from either
        form_ok = all((a is None) == (k not in wanted) and
                      (b is None) == (k not in wanted)
                      for k, a, b in zip(names, kg, pg))
        good = (launches == (1, 1) and form_ok and bg_rel <= BG_BWD_RTOL
                and all(rel <= GRAD_BWD_REL and cos >= GRAD_BWD_COS
                        for rel, cos in stats.values())
                and all(float(b.abs().max()) > 0
                        for k, b in zip(names, pg) if k in wanted)
                and all(bool(torch.isfinite(a).all()) for a in got))
        log(f"volume gradients [{label}] {form}: kernel vs plain autograd "
            f"on {lanes.numel()} lanes, loss over colour and depth "
            f"(launches fwd/bwd {launches}, leaves with a gradient "
            f"{[k for k, a in zip(names, kg) if a is not None]}): "
            + "; ".join(f"{k} rel_l2={r:.3e} cos={c:.8f}"
                        for k, (r, c) in stats.items())
            + f"; bg max_rel={bg_rel:.3e}; max_abs={max_abs:.3e}; plain "
            f"fwd+bwd {plain_s:.3f} s {'OK' if good else 'FAIL'}")
        return good, stats, bg_rel, max_abs, plain_s

    good_tt, stats, bg_rel, max_abs, plain_s = check_form(
        "texels and transfer (volume_bwd_kernel<false>, the training "
        "step's form)", ("texels", "transfer"))
    good_all, stats_all, bg_rel_all, max_abs_all, plain_all_s = check_form(
        "every gradient (volume_bwd_kernel<true>)", names)
    good = good_tt and good_all
    tex_rel, tex_cos = stats["texels"]
    tr_rel, tr_cos = stats["transfer"]

    # the volume training step at full width
    with torch.no_grad():
        target = render(dataclasses.replace(scene, volumes=dataclasses.replace(
            vols, transfer=vols.transfer * TARGET_TRANSFER_SCALE)), cam,
            WIDTH, HEIGHT, algo="volume").color

    def vstep():
        tex = vols.texels.detach().clone().requires_grad_()
        tr = vols.transfer.detach().clone().requires_grad_()
        gscene = dataclasses.replace(scene, volumes=dataclasses.replace(
            vols, texels=tex, transfer=tr))
        with torch.enable_grad():
            color = render(gscene, cam, WIDTH, HEIGHT, algo="volume").color
            loss = ((color - target) ** 2).mean()
            g_tex, g_tr = torch.autograd.grad(loss, (tex, tr))
        torch.cuda.synchronize()
        return loss, g_tex, g_tr

    t0 = time.perf_counter()
    vstep()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    trav.reset_launch_counts()
    t0 = time.perf_counter()
    loss, g_tex, g_tr = vstep()
    times = [time.perf_counter() - t0]
    step_launches = {k: v for k, v in trav.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    for _ in range(TIMED_STEPS - 1):
        t0 = time.perf_counter()
        vstep()
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)
    finite = all(bool(torch.isfinite(x).all()) for x in (loss, g_tex, g_tr))
    step_ok = (finite and float(g_tex.abs().max()) > 0
               and float(g_tr.abs().max()) > 0
               and step_launches == {"volume_march": 1, "volume_bricks": 1,
                                     "volume_march_bwd": 1})
    # the backward kernel alone on the step's rays: its time and bound
    bg = torch.tensor(RENDER_BG, device=dev)
    with torch.no_grad():
        color, _, _, dst = tvol._launch(o, d, vols, bg, 1.0, save_dst=True)
        gcolor = (2.0 / color.numel()) * (color - target.reshape(-1, 4))
        steps = torch.zeros(n, dtype=torch.int32, device=dev)
        volume_march(o, d, vols, bg, steps=steps)
        total = int(steps.sum(dtype=torch.int64))
        bwd_ms = cuda_ms(lambda: tvol.march_backward(
            o, d, vols, bg, dst, gcolor, wanted=("texels", "transfer")), 3)
        bwd_tr_ms = cuda_ms(lambda: tvol.march_backward(
            o, d, vols, bg, dst, gcolor, wanted=("transfer",)), 3)
        bwd_all_ms = cuda_ms(lambda: tvol.march_backward(
            o, d, vols, bg, dst, gcolor), 3)
        # the shared-memory adds of the transfer gradient, in each form
        tr_adds = [torch.zeros(1, dtype=torch.int64, device=dev)
                   for _ in range(2)]
        tvol.march_backward(o, d, vols, bg, dst, gcolor,
                            wanted=("texels", "transfer"), counts=tr_adds[0])
        tvol.march_backward(o, d, vols, bg, dst, gcolor, counts=tr_adds[1])
        tr_adds = [int(x) for x in tr_adds]
        fwd_ms = cuda_ms(lambda: volume_march(o, d, vols, bg), 3)
    t_bytes = volume_bwd_bytes(n, vols) / PEAK_BYTES_S * 1e3
    atomic_bytes = volume_atomic_bytes(total)
    t_ops = total * FLOP_STEP_BWD / PEAK_F32_S * 1e3
    bound = max(t_bytes, t_ops)
    # every gradient: the rays' (n, 6) written once and the boxes' flushed
    # once a block, beside the texels' and transfer's
    blocks = min(-(-n // 128), 2048)
    all_bytes = (volume_bwd_bytes(n, vols) + n * 6 * 4
                 + blocks * vols.lo.numel() * 2 * 16) / PEAK_BYTES_S * 1e3
    all_ops = total * FLOP_STEP_BWD_ALL / PEAK_F32_S * 1e3
    bound_all = max(all_bytes, all_ops)
    form = ptx.get("volume_bwd pos=0", {})
    form_pos = ptx.get("volume_bwd pos=1", {})
    ok = good and step_ok
    log(f"volume step [{label}] {WIDTH}x{HEIGHT} MSE vs transfer x "
        f"{TARGET_TRANSFER_SCALE} over texels and transfer: step_s="
        f"{step_s:.4f} (steps {', '.join(f'{t:.4f}' for t in times)}) "
        f"warm_s={warm_s:.3f} launches={step_launches} peak_bytes={peak} "
        f"(+{peak - base_mem}) loss={float(loss.detach()):.6e} "
        f"finite={finite} | "
        f"backward kernel, texels and transfer (<false>): ms={bwd_ms:.4f} "
        f"(transfer only {bwd_tr_ms:.4f}) bound_ms={bound:.4f} "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}; bytes "
        f"{t_bytes:.4f}, operations {t_ops:.4f}) registers="
        f"{form.get('regs')} stack={form.get('stack')} spills="
        f"{form.get('spill')} texel rel_l2={tex_rel:.3e} transfer "
        f"rel_l2={tr_rel:.3e} | every gradient (<true>): ms="
        f"{bwd_all_ms:.4f} bound_ms={bound_all:.4f} registers="
        f"{form_pos.get('regs')} stack={form_pos.get('stack')} spills="
        f"{form_pos.get('spill')} rel_l2 "
        + " ".join(f"{k}={stats_all[k][0]:.3e}" for k in names)
        + f" | forward {fwd_ms:.4f} steps={total} texel_atomic_bytes="
        f"{atomic_bytes} transfer_atomics={tr_adds[0]} (every gradient "
        f"{tr_adds[1]}; at most {8 * total} without the thread and warp "
        f"sums: 8 a step) {'OK' if ok else 'FAIL'}")
    entries.append({
        "name": f"volume_march_bwd_{label.replace(' ', '_')}",
        "route": "cuda", "source": VOLUME_BWD_SOURCE,
        "entry": VOLUME_BWD_ENTRY, "replaces": VOLUME_REPLACES,
        "mode_key": "volume_march_bwd",
        "launches": step_launches.get("volume_march_bwd", 0),
        "max_abs_err": max(max_abs, max_abs_all), "ms": bwd_ms,
        "plain_ms": plain_s * 1e3,
        "plain_lanes": int(lanes.numel()), "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "lanes": n, "steps": total,
        "flop_step": FLOP_STEP_BWD, "bytes_ms": t_bytes, "ops_ms": t_ops,
        "texel_atomic_bytes": atomic_bytes,
        "transfer_atomics": tr_adds[0],
        "transfer_atomics_all_gradients": tr_adds[1],
        "transfer_atomics_unsummed_max": 8 * total, "redesigned": 12,
        "ms_transfer_only": bwd_tr_ms, "texel_rel_l2": tex_rel,
        "texel_cos": tex_cos, "transfer_rel_l2": tr_rel,
        "transfer_cos": tr_cos, "bg_max_rel": bg_rel,
        "ms_all_gradients": bwd_all_ms, "bound_ms_all_gradients": bound_all,
        "plain_ms_all_gradients": plain_all_s * 1e3,
        "flop_step_all": FLOP_STEP_BWD_ALL,
        "max_abs_err_all_gradients": max_abs_all,
        "bg_max_rel_all_gradients": bg_rel_all,
        **{f"{k}_rel_l2_all_gradients": stats_all[k][0] for k in names},
        **{f"{k}_cos_all_gradients": stats_all[k][1] for k in names},
        "registers": form.get("regs"), "stack": form.get("stack"),
        "spills": form.get("spill"),
        "registers_all_gradients": form_pos.get("regs"),
        "spills_all_gradients": form_pos.get("spill"),
        "launches_training_step":
            step_launches.get("volume_march_bwd", 0), "phase": label})
    return ok, dict(step_s=step_s, step_times=times, warm_s=warm_s,
                    peak_bytes=peak, bwd_kernel_ms=bwd_ms,
                    bwd_kernel_transfer_only_ms=bwd_tr_ms,
                    bwd_kernel_all_ms=bwd_all_ms,
                    bwd_all_bound_ms=bound_all,
                    all_gradients_rel_l2={k: stats_all[k][0]
                                          for k in names},
                    fwd_kernel_ms=fwd_ms, bound_ms=bound, steps=total,
                    transfer_atomics=tr_adds[0],
                    texel_rel_l2=tex_rel, transfer_rel_l2=tr_rel,
                    launches=step_launches, plain_s=plain_s), vstep


def run_cli(label, argv):
    """``cli.main(argv + CLI_SIZE)`` with its stdout captured: (ok, lines,
    wall seconds, launches); counts reset just before."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    trav.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + CLI_SIZE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in trav.LAUNCHES.items() if v}
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  cli[{label}]: {line[:400]}")
    return rc == 0, lines, wall, launches


def written(lines):
    """The image file the CLI's last line names."""
    return lines[-1].rsplit("-> ", 1)[1]


def cli_image(path):
    img = load_image(path, srgb=False)
    return img[..., :3]


def cli_phase(dev, tmp):
    """Phase 21: the CLI runs, each with its wall seconds and check."""
    out, ok_all = {}, True

    def record(label, good, wall, launches, **info):
        nonlocal ok_all
        ok_all &= bool(good)
        out[label] = dict(wall_s=wall, launches=launches, ok=bool(good),
                          **info)
        log(f"cli {label}: wall_s={wall:.3f} launches={launches} "
            + " ".join(f"{k}={v}" for k, v in info.items())
            + f" {'OK' if good else 'FAIL'}")

    def image_ok(path):
        img = cli_image(path)
        return bool(np.isfinite(img).all() and img.std() > 0), img

    # (a) the teapot, simple, on its LBVH
    rc, lines, wall, launches = run_cli(
        "teapot", ["--scene", "builtin:teapot", "-o", f"{tmp}/teapot.png"])
    good, _ = image_ok(written(lines)) if rc else (False, None)
    record("teapot_simple", good and launches == {"lbvh_closest": 1}, wall,
           launches, file=written(lines))

    # (b) the main path through the CLI
    main_argv = ["--scene", "builtin:sponza", "--bvh", "cluster",
                 "--algorithm", "pathtracing", "--nee"]
    rc, lines, wall, launches = run_cli(
        "sponza_pt", main_argv + ["-o", f"{tmp}/sponza_pt.png"])
    good, pt_img = image_ok(written(lines)) if rc else (False, None)
    modes = all(launches.get(k, 0) > 0 for k, _, _ in MODES)
    record("sponza_cluster_pt_nee", good and modes, wall, launches,
           file=written(lines))

    # (c) OBJ round trip of the 260k mesh, its simple frame on its LBVH
    scene, cam = sponza_like_scene(target_tris=TARGET_TRIS, build_bvh=False,
                                   device=dev)
    t0 = time.perf_counter()
    save_obj(f"{tmp}/sponza.obj", scene.mesh)
    save_camera(f"{tmp}/sponza.cam", cam)
    save_s = time.perf_counter() - t0
    rc, lines, wall, launches = run_cli(
        "obj", ["--scene", f"{tmp}/sponza.obj", "--camera",
                f"{tmp}/sponza.cam", "-o", f"{tmp}/obj.png"])
    t0 = time.perf_counter()
    oscene = load_obj_scene(f"{tmp}/sponza.obj", device=dev)
    load_s = time.perf_counter() - t0
    same_mesh = (torch.equal(oscene.mesh.vertices, scene.mesh.vertices)
                 and torch.equal(oscene.mesh.faces, scene.mesh.faces))
    ref = render(oscene, load_camera(f"{tmp}/sponza.cam", device=dev),
                 WIDTH, HEIGHT)
    ref_path = save_png(f"{tmp}/obj_ref.png", ref.color[..., :3])
    same_img = rc and open(written(lines), "rb").read() == \
        open(ref_path, "rb").read()
    good = rc and same_mesh and same_img and launches == {"lbvh_closest": 1}
    record("obj_round_trip", good, wall, launches, save_obj_s=round(save_s, 3),
           load_obj_scene_s=round(load_s, 3), mesh_equal=same_mesh,
           image_equal_to_render=bool(same_img),
           tris=oscene.num_triangles)
    del oscene, ref

    # (d) sponza x16 on a ClusterBVH (radix, run-time K), then on SAH
    for bvh, want in (("cluster", "radix_closest"), ("sah", "lbvh_closest")):
        rc, lines, wall, launches = run_cli(
            f"x16_{bvh}", ["--scene", "builtin:sponza_x16", "--bvh", bvh,
                           "-o", f"{tmp}/x16_{bvh}.png"])
        good, _ = image_ok(written(lines)) if rc else (False, None)
        record(f"sponza_x16_{bvh}_simple", good and launches == {want: 1},
               wall, launches, file=written(lines))

    # (e) the volume frame
    rc, lines, wall, launches = run_cli(
        "volume", ["--scene", "builtin:volume", "--algorithm", "volume",
                   "-o", f"{tmp}/volume.png"])
    good, _ = image_ok(written(lines)) if rc else (False, None)
    record("volume", good and launches == {"volume_march": 1,
                                           "volume_bricks": 1}, wall,
           launches)

    # (f) the main path's frame through the elastic scheduler, resumed
    rc, lines, wall, launches = run_cli(
        "elastic", main_argv + ["--elastic", "--elastic-checkpoint",
                                f"{tmp}/ck", "--elastic-batch",
                                str(ELASTIC_BATCH), "-o",
                                f"{tmp}/elastic.png"])
    reps = [json.loads(s) for s in lines if s.startswith('{"elastic')]
    full = np.load(f"{tmp}/ck.f1.npz")
    good = rc and len(reps) == 1 and reps[0]["failed"] == 0 and \
        reps[0]["completed"] == reps[0]["batches"] and bool(full["done"].all())
    # the same frame in process, interrupted after 5 batches, resumed
    escene, ecam = sponza_like_scene(target_tris=TARGET_TRIS,
                                     build_bvh=False, device=dev)
    escene.bvh = build_cluster_bvh(escene.mesh, treelet_size=T)
    eparams, sampler = cli.elastic_params(escene, "pathtracing")

    def stop(b, attempt):
        if b >= ELASTIC_STOP:
            raise RuntimeError("preempted")

    _, rep1 = render_frame_elastic(eparams, ecam, WIDTH, HEIGHT, nee=True,
                                   pixel_sampler=sampler, retries=0,
                                   batch=ELASTIC_BATCH,
                                   checkpoint_path=f"{tmp}/resume.npz",
                                   checkpoint_every=1, fault_hook=stop)
    img2, rep2 = render_frame_elastic(eparams, ecam, WIDTH, HEIGHT,
                                      nee=True, pixel_sampler=sampler,
                                      batch=ELASTIC_BATCH,
                                      checkpoint_path=f"{tmp}/resume.npz")
    cli_color = full["color"][:WIDTH * HEIGHT].reshape(HEIGHT, WIDTH, 4)
    resumed_same = bool(np.array_equal(img2, cli_color))
    good = good and rep1.completed == ELASTIC_STOP and rep1.failed > 0 \
        and rep2.ok and rep2.resumed == ELASTIC_STOP and resumed_same
    pt_diff = float(np.abs(cli_image(written(lines)) - pt_img).mean()) \
        if pt_img is not None and rc else float("nan")
    record("elastic_resume", good, wall, launches,
           batches=reps[0]["batches"] if reps else None,
           interrupted_completed=rep1.completed, resumed=rep2.resumed,
           resumed_bit_identical=resumed_same,
           mean_abs_vs_plain_frame=pt_diff)
    del escene, eparams

    # (g) --dump-bvh of (b)'s tree
    rc, lines, wall, launches = run_cli(
        "dump_bvh", main_argv + ["--dump-bvh", f"{tmp}/bvh.png"])
    stats = [json.loads(s) for s in lines if s.startswith('{"bvh_dump')]
    good = rc and len(stats) == 1 and stats[0]["nodes"] > 1 and \
        stats[0].get("num_treelets", 0) > 1
    record("dump_bvh", good, wall, launches,
           stats=stats[0] if stats else None)

    # (h) a progressive RGBA8 typed target over 4 frames (LBVH), against
    # the same frames blended in process into a typed target
    rc, lines, wall, launches = run_cli(
        "typed", ["--scene", "builtin:sponza", "--algorithm", "pathtracing",
                  "--nee", "--frames", str(TYPED_FRAMES), "--pixel-format",
                  "RGBA8", "--no-srgb", "-o", f"{tmp}/typed.png"])
    tscene, tcam = sponza_like_scene(target_tris=TARGET_TRIS, device=dev)
    rt = make_typed_render_target(WIDTH, HEIGHT, "RGBA8", device=dev)
    for frame in range(1, TYPED_FRAMES + 1):
        rt = render(tscene, tcam, WIDTH, HEIGHT, algo="pathtracing",
                    nee=True, frame_num=frame, rt=rt)
    ref_path = save_png(f"{tmp}/typed_ref.png", rt.as_float()[..., :3],
                        srgb=False)
    same = rc and open(written(lines), "rb").read() == \
        open(ref_path, "rb").read()
    good, _ = image_ok(written(lines)) if rc else (False, None)
    good = good and same and rt.color.dtype == torch.uint8 and \
        launches.get("lbvh_closest", 0) == 10 * TYPED_FRAMES
    record("typed_rgba8_progressive", good, wall, launches,
           equal_to_in_process=bool(same))
    return ok_all, out


# ---------------------------------------------------------------------------
# Phases 22-23: parallel/ (torch.distributed).  The ranks are processes of
# this script (``--rank-worker``), spawned and waited on by the parent; a
# rank's failure or timeout fails the phase.  On one card two ranks share
# the GPU over a gloo group, whose transport stages CUDA tensors through
# host buffers (parallel/comm.py): every time of these phases is two ranks
# sharing one card over host loopback, not a multi-GPU number.

RANKS = 2            # on one card: a gloo group (NCCL refuses two a card)
RANK_TIMEOUT = 900
RANK_BG = (0.2, 0.3, 0.5, 1.0)   # the main path's background
CONFIG5_SIZE = (3840, 2160)      # BASELINE config #5: 4K
CONFIG5_BACKENDS = ("lbvh", "cluster")
CONFIG5_GRAD_SIZE = (WIDTH, HEIGHT)
CONFIG5_CHECK = 32               # kernel vs plain gradients at 32 x 32
# tests/test_sharded_render.py's rule for a sharded frame against the
# unsharded one: channels within atol 2e-3 / rtol 1e-4, means within 5e-3
SHARD_CLOSE_SHARE, SHARD_MEAN_RTOL = 0.995, 5e-3


def spawn_ranks(task, world, comm_backend, tmp):
    """Run ``task`` on ``world`` rank processes (multihost.spawn_local)
    and wait for all of them; (ok, per-rank results).  A rank that exits
    non-zero, or the time limit, ends the others at once and fails the
    phase."""
    logs = [open(f"{tmp}/{task}_{world}_{r}.log", "w") for r in range(world)]
    try:
        codes = multihost.spawn_local(
            world, [__file__, "--rank-worker", task, comm_backend, tmp],
            timeout=RANK_TIMEOUT, outputs=logs)
    finally:
        for f in logs:
            f.close()
    results = []
    for r, code in enumerate(codes):
        with open(f"{tmp}/{task}_{world}_{r}.log") as f:
            for line in f.read().rstrip().splitlines():
                log(f"  [{task} rank {r}/{world}] {line}")
        if code != 0:
            log(f"FAIL: {task} rank {r} of {world} exited {code}")
            continue
        with open(f"{tmp}/{task}_{world}_{r}.json") as f:
            results.append(json.load(f))
    return len(results) == world, results


def _rank_stats(t0, comm):
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                transport=dict(comm.STATS),
                launches={k: v for k, v in trav.LAUNCHES.items() if v},
                entry_launches={k: v for k, v in trav.ENTRY_LAUNCHES.items()
                                if v})


def _reset_rank_counts(comm):
    """Zero the counters once every rank is here (so a timed section does
    not count the wait for a slower rank's earlier work)."""
    torch.cuda.synchronize()
    torch.distributed.barrier()
    comm.reset_stats()
    trav.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()


def tile_worker(rank, world, dev, tmp, comm, res):
    """Phase 22 on one rank: the main path's frame through
    render_image_sharded, then examples/inverse_rendering.py's gradient
    at 1080p (MSE over the frame; cd and ls, all-reduced)."""
    from visionaray_torch.parallel.tile_sharding import (
        all_reduce_grads, make_mesh, render_image_sharded,
    )
    mesh = make_mesh()
    scene, cam = sponza_like_scene(target_tris=TARGET_TRIS, build_bvh=False,
                                   device=dev)
    scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=K, treelet_size=T)
    params = KernelParams.create(scene, num_bounces=BOUNCES, epsilon=1e-3,
                                 bg_color=RANK_BG,
                                 ambient_color=(1.0, 1.0, 1.0, 1.0))

    def frame(num, p=params):
        return render_image_sharded(p, cam, WIDTH, HEIGHT, mesh,
                                    algo="pathtracing", spp=SPP,
                                    pixel_sampler="jittered_blend",
                                    frame_num=num, nee=True)

    with torch.no_grad():
        frame(1)
        _reset_rank_counts(comm)
        t0 = time.perf_counter()
        color, _ = frame(2)
        res["frame"] = _rank_stats(t0, comm)
        if rank == 0:
            np.save(f"{tmp}/tile_{world}_color.npy", color.cpu().numpy())
        comm.reset_stats()
        res["profile"] = profile_run(lambda: frame(3),
                                     f"tile rank {rank}/{world} frame")
        res["profile"]["staging_s"] = comm.STATS["staging_s"]
        mats = scene.materials
        target = frame(9999)[0][..., :3]

    def theta_params(cd, ls):
        m = dataclasses.replace(mats, cd=cd, ls=ls)
        return dataclasses.replace(params, scene=dataclasses.replace(
            scene, materials=m))

    def grad_step():
        cd = torch.clip(mats.cd * 0.3 + 0.3, 0.05, 0.95).requires_grad_()
        ls = (mats.ls * 0.5).requires_grad_()
        loss = torch.mean((frame(1, theta_params(cd, ls))[0][..., :3]
                           - target) ** 2)
        loss.backward()
        all_reduce_grads([cd, ls], mesh)
        return loss, cd, ls

    grad_step()   # warm: the backward's first run
    _reset_rank_counts(comm)
    t0 = time.perf_counter()
    loss, cd, ls = grad_step()
    res["grad_step"] = _rank_stats(t0, comm)
    res["loss"] = float(loss.detach())
    np.save(f"{tmp}/tile_{world}_{rank}_gcd.npy", cd.grad.cpu().numpy())
    np.save(f"{tmp}/tile_{world}_{rank}_gls.npy", ls.grad.cpu().numpy())
    return True


def _soup_bytes(soup):
    return sum(x.numel() * x.element_size() for x in (
        soup.v1, soup.e1, soup.e2, soup.geom_ids, soup.corner_normals,
        soup.tex_coords))


def geo_worker(backend, rank, world, dev, tmp, comm, res):
    """Phase 23 on one rank: config #5 sharded over the ranks, the 4K
    frame through render_image_geometry_sharded (every hop's launches
    recorded and held against the plain version), then the soup's vertex
    gradient at 1080p through soup_grads_to_faces, and kernel against
    plain gradients at 32 x 32."""
    from visionaray_torch.parallel import ring
    from visionaray_torch.parallel.sharded_pt import (
        render_image_geometry_sharded, soup_grads_to_faces,
    )
    from visionaray_torch.parallel.tile_sharding import make_mesh
    from visionaray_torch.scenes import sponza_x16_scene
    mesh = make_mesh()
    t0 = time.perf_counter()
    scene, cam = sponza_x16_scene(device=dev)
    F = scene.num_triangles
    geo = ring.shard_geometry(scene.mesh, world, backend=backend,
                              with_shading=True, shards=(rank,))
    torch.cuda.synchronize()
    res["shard_s"] = time.perf_counter() - t0
    full = ring.SoupMesh(*[torch.empty((F,) + tuple(x.shape[2:]),
                                       dtype=x.dtype, device="meta")
                           for x in (geo.soup.v1, geo.soup.e1, geo.soup.e2,
                                     geo.soup.geom_ids,
                                     geo.soup.corner_normals,
                                     geo.soup.tex_coords)])
    mats, lights = scene.materials, scene.lights
    del scene
    torch.cuda.empty_cache()
    res.update(triangles=F, prims_per_shard=geo.prims_per_shard,
               soup_bytes=_soup_bytes(geo.soup),
               unsharded_soup_bytes=_soup_bytes(full),
               allocated_bytes=torch.cuda.memory_allocated())
    if backend == "cluster":
        b = geo.bvh[0]
        res["cluster"] = dict(K=b.cluster_size, C=b.num_clusters,
                              depth=b.depth, heap=b.heap,
                              entry=trav.launch_form(
                                  b.heap, b.num_clusters, False, False, 2,
                                  False, b.cluster_size)[0])
    W5, H5 = CONFIG5_SIZE

    def frame(num, w=W5, h=H5, g=geo):
        return render_image_geometry_sharded(
            g, mats, lights, cam, w, h, mesh, num_bounces=BOUNCES, spp=SPP,
            eps=1e-3, bg_color=RANK_BG, ambient=(1.0, 1.0, 1.0),
            frame_num=num, nee=True)

    lbvh = backend == "lbvh"
    with torch.no_grad():
        rec = BvhRecorder(tt.bvh_traverse) if lbvh else \
            LaunchRecorder(trav.cluster_traverse)
        with (bvh_recorded(rec) if lbvh else recorded(rec)):
            frame(1)
        _reset_rank_counts(comm)
        t0 = time.perf_counter()
        color, _ = frame(2)
        res["frame"] = _rank_stats(t0, comm)
        counts = dict(trav.LAUNCHES)
        if rank == 0:
            np.save(f"{tmp}/geo_{backend}_{world}_color.npy",
                    color.cpu().numpy())
        del color
        comm.reset_stats()
        res["profile"] = profile_run(
            lambda: frame(3), f"config #5 {backend} rank {rank} frame")
        res["profile"]["staging_s"] = comm.STATS["staging_s"]
        ok, entries = True, []
        for key, lns in rec.launches.items():
            name = f"traverse_{key}_config5_{backend}_rank{rank}"
            if lbvh:
                good, entry = check_lbvh_mode(key, name, lns, counts)
            else:
                good, entry = check_mode(key, name, "1e", lns, geo.bvh[0],
                                         counts)
            entry.update(phase=f"23 {backend} rank {rank}",
                         launches_training_step=0)
            entries.append(entry)
            ok &= good
        res["entries"] = entries
        del rec

    # the vertex gradient at 1080p, mapped to faces
    leaves = [geo.soup.v1, geo.soup.e1, geo.soup.e2]
    for x in leaves:
        x.requires_grad_()
    _reset_rank_counts(comm)
    t0 = time.perf_counter()
    loss = frame(1, *CONFIG5_GRAD_SIZE)[0][..., :3].mean()
    loss.backward()
    res["grad_step"] = _rank_stats(t0, comm)
    g_faces = soup_grads_to_faces(geo.soup.v1.grad, geo.prim_ids, F)
    mine = torch.zeros(F, dtype=torch.bool, device=dev)
    mine[geo.prim_ids.reshape(-1).long()] = True
    res["grad"] = dict(
        loss=float(loss.detach()),
        finite=all(bool(torch.isfinite(x.grad).all()) for x in leaves),
        norm=float(g_faces.norm()), faces_nonzero=int(
            (g_faces.abs().sum(-1) > 0).sum()),
        outside_shard=float(g_faces[~mine].abs().sum()))
    log(f"rank {rank} 1080p soup gradient: {res['grad']}")
    # a shard that wins no hit of the frame has a zero gradient (the
    # parent requires a non-zero one on some rank)
    ok &= res["grad"]["finite"] and res["grad"]["outside_shard"] == 0.0
    for x in leaves:
        x.grad = None
    del loss, g_faces

    # kernel against plain gradients at 32 x 32
    def small():
        for x in leaves:
            x.grad = None
        lo = frame(1, CONFIG5_CHECK, CONFIG5_CHECK)[0][..., :3].mean()
        lo.backward()
        return float(lo.detach()), [x.grad.clone() for x in leaves]

    loss_k, gk = small()
    with (plain_bvh() if lbvh else plain_traversal()):
        loss_p, gp = small()
    stats = [grad_stats(a, b) for a, b in zip(gk, gp)]
    # a zero gradient (no hit on this shard) has no rel_l2 or cos: None
    res["grad_check"] = dict(loss_rel=abs(loss_k - loss_p) / abs(loss_p),
                             rel_l2=[None if r != r else r
                                     for r, _ in stats],
                             cos=[None if c != c else c for _, c in stats],
                             plain_norm=[float(b.norm()) for b in gp])
    log(f"rank {rank} 32x32 kernel vs plain gradients: "
        f"{res['grad_check']}")
    # a rank whose shard wins no 32 x 32 hit has zero gradients, through
    # the kernel as through the plain version
    ok &= res["grad_check"]["loss_rel"] <= LOSS_RTOL and all(
        (float(b.norm()) == 0 and float(a.norm()) == 0)
        or (rel <= GRAD_REL_L2 and cos >= GRAD_COS)
        for (rel, cos), a, b in zip(stats, gk, gp))
    return ok


def rank_worker(argv):
    """``chip_smoke.py --rank-worker TASK BACKEND TMP``, with RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT in the environment
    (spawn_ranks): one rank of phase 22 (TASK tile) or 23 (geo_lbvh,
    geo_cluster); its results go to TMP/TASK_WORLD_RANK.json.  Exits
    non-zero on failure."""
    from visionaray_torch.parallel import comm
    task, backend, tmp = argv
    multihost.initialize(backend=backend, device="cuda")
    try:
        rank = torch.distributed.get_rank()
        world = torch.distributed.get_world_size()
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        trav._library()   # built by the parent: the same hash, loaded here
        res = dict(task=task, rank=rank, world=world, backend=backend)
        if task == "tile":
            ok = tile_worker(rank, world, dev, tmp, comm, res)
        else:
            ok = geo_worker(task.split("_", 1)[1], rank, world, dev, tmp,
                            comm, res)
        res["ok"] = bool(ok)
        with open(f"{tmp}/{task}_{world}_{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        multihost.shutdown()
    log(f"rank {rank}/{world} {task}: {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def _grad_close(a, b):
    """(rel_l2, cos, ok) of two gradients; two zero gradients agree."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if float(b.abs().max()) == 0.0:
        return 0.0, 1.0, float(a.abs().max()) == 0.0
    rel, cos = grad_stats(a, b)
    return rel, cos, rel <= GRAD_REL_L2 and cos >= GRAD_COS


def tile_phase(params, cam, dev, tmp):
    """Phase 22: tile sharding of the main path at 1080p: (a) one rank on
    NCCL against render_pixels over the same flat pixel ids in this
    process, (b) two gloo ranks on the card against (a); the
    inverse-rendering gradient of two ranks against one rank's."""
    ok1, one = spawn_ranks("tile", 1, "nccl", tmp)
    ok2, two = spawn_ranks("tile", RANKS, "gloo", tmp)
    ok = ok1 and ok2 and all(r["ok"] for r in one + two)
    if not (ok1 and ok2):
        return False, {}
    x, y = _pixel_grid(WIDTH, HEIGHT, dev)
    with torch.no_grad():
        ref = render_pixels(params, cam, x, y, WIDTH, HEIGHT, "pathtracing",
                            SPP, "jittered_blend", 2, nee=True)[0]
    c1 = torch.as_tensor(np.load(f"{tmp}/tile_1_color.npy"),
                         device=dev).reshape(-1, 4)
    c2 = torch.as_tensor(np.load(f"{tmp}/tile_{RANKS}_color.npy"),
                         device=dev).reshape(-1, 4)
    d1 = image_diff(c1, ref)
    d2 = image_diff(c2, c1)
    px1 = int(((c1 - ref).abs().amax(-1) > 0).sum())
    px2 = int(((c2 - c1).abs().amax(-1) > 0).sum())
    img_ok = all(m <= IMG_MEAN_ABS and sh <= IMG_PIX_SHARE
                 for m, sh in (d1, d2)) and bool(torch.isfinite(c2).all())
    g = {}
    for k in ("gcd", "gls"):
        a1 = np.load(f"{tmp}/tile_1_0_{k}.npy")
        a2 = [np.load(f"{tmp}/tile_{RANKS}_{r}_{k}.npy")
              for r in range(RANKS)]
        same = all(np.array_equal(a2[0], a) for a in a2[1:])
        g[k] = (*_grad_close(a2[0], a1), same)
    loss_rel = max(abs(r["loss"] - one[0]["loss"]) / abs(one[0]["loss"])
                   for r in two)
    grad_ok = loss_rel <= LOSS_RTOL and all(v[2] and v[3]
                                            for v in g.values())
    ok = ok and img_ok and grad_ok
    log(f"tile sharding 1920x1080 spp=1 bounces=5 nee, treelet ClusterBVH "
        f"K={K} T={T} (two ranks share one card over gloo, host loopback): "
        f"(a) 1 rank nccl vs render_pixels mean_abs={d1[0]:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={d1[1]:.5f} differing_pixels={px1}; "
        f"(b) {RANKS} ranks gloo vs (a) mean_abs={d2[0]:.3e} "
        f"pixels_over_{IMG_PIX_TOL:g}={d2[1]:.5f} differing_pixels={px2} "
        f"{'OK' if img_ok else 'FAIL'}")
    for label, rs in (("1 rank nccl", one), (f"{RANKS} ranks gloo", two)):
        for r in rs:
            f, st = r["frame"], r["grad_step"]
            log(f"  {label} rank {r['rank']}: frame_s={f['seconds']:.4f} "
                f"peak_mem_bytes={f['peak_mem_bytes']} launches="
                f"{f['launches']} entry_launches={f['entry_launches']} "
                f"staging_s={f['transport']['staging_s']:.4f} "
                f"staged_bytes={f['transport']['staged_bytes']} | grad "
                f"step_s={st['seconds']:.4f} peak_mem_bytes="
                f"{st['peak_mem_bytes']} launches={st['launches']} "
                f"staging_s={st['transport']['staging_s']:.4f} "
                f"loss={r['loss']:.7e}")
    log(f"  inverse-rendering gradient (MSE over the frame; cd, ls; "
        f"all-reduced) {RANKS} ranks vs 1: loss_rel={loss_rel:.3e} "
        + " ".join(f"{k} rel_l2={v[0]:.3e} cos={v[1]:.9f} "
                   f"equal_on_ranks={v[3]}" for k, v in g.items())
        + f" {'OK' if grad_ok else 'FAIL'}")
    return ok, dict(one=one, two=two, image_1_vs_plain=d1,
                    image_2_vs_1=d2, differing_pixels=[px1, px2],
                    grad={k: list(v) for k, v in g.items()},
                    loss_rel=loss_rel)


def _sharded_close(a, b):
    close = torch.isclose(a, b, atol=2e-3, rtol=1e-4).float().mean()
    mrel = abs(float(a.mean()) - float(b.mean())) / abs(float(b.mean()))
    return float(close), mrel


def config5_phase(dev, tmp, entries, world=RANKS):
    """Phase 23: config #5 (sponza_x16_scene, 4,154,496 triangles) sharded
    over ``world`` ranks, on the lbvh and cluster backends, against the
    unsharded frame rendered here on the card.  The ranks take a card
    each over NCCL where there are enough cards, else share them over
    gloo (multihost.local_backend): two gloo ranks on one card here,
    scripts/torch_config5_ranks.py's four NCCL ranks on four."""
    from visionaray_torch.scenes import sponza_x16_scene
    comm_backend = multihost.local_backend(world, dev)
    out, ok = {}, True
    for backend in CONFIG5_BACKENDS:
        good, rs = spawn_ranks(f"geo_{backend}", world, comm_backend, tmp)
        ok &= good and all(r["ok"] for r in rs)
        out[backend] = rs
        for r in rs:
            entries.extend(r.get("entries", []))
    torch.cuda.empty_cache()
    W5, H5 = CONFIG5_SIZE
    with torch.no_grad():
        scene, cam = sponza_x16_scene(device=dev)
        t0 = time.perf_counter()
        scene.bvh = build_lbvh(scene.mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        params = KernelParams.create(scene, num_bounces=BOUNCES,
                                     epsilon=1e-3, bg_color=RANK_BG,
                                     ambient_color=(1.0, 1.0, 1.0, 1.0))
        t0 = time.perf_counter()
        ref, _ = step_free_frame(params, cam, W5, H5)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    out["unsharded"] = dict(frame_s=ref_s, lbvh_build_s=build_s)
    log(f"config #5 unsharded reference: sponza_x16 "
        f"{scene.num_triangles} triangles, LBVH built in {build_s:.3f} s, "
        f"{W5}x{H5} NEE frame in tiles {ref_s:.3f} s (one process)")
    for backend in CONFIG5_BACKENDS:
        rs = out[backend]
        if len(rs) != world:
            log(f"FAIL: config #5 {backend}: a rank failed")
            ok = False
            continue
        img = torch.as_tensor(np.load(
            f"{tmp}/geo_{backend}_{world}_color.npy"), device=dev)
        close, mrel = _sharded_close(img, ref)
        img_ok = (close > SHARD_CLOSE_SHARE and mrel <= SHARD_MEAN_RTOL
                  and bool(torch.isfinite(img).all()))
        ok &= img_ok
        half = all(abs(r["soup_bytes"] / r["unsharded_soup_bytes"]
                       - 1.0 / world) < 0.01 for r in rs)
        grad_faces = sum(r["grad"]["faces_nonzero"] for r in rs)
        ok &= half and grad_faces > 0
        log(f"config #5 [{backend}] {W5}x{H5} spp=1 bounces=5 nee on "
            f"{world} ranks over {comm_backend} on "
            f"{torch.cuda.device_count()} card(s): "
            f"channels_close={close:.5f} mean_rel={mrel:.3e} vs the "
            f"unsharded frame {'OK' if img_ok else 'FAIL'}; soup bytes "
            f"a rank {[r['soup_bytes'] for r in rs]} of "
            f"{rs[0]['unsharded_soup_bytes']} unsharded "
            f"{'OK' if half else 'FAIL'}; faces with a 1080p vertex "
            f"gradient {grad_faces} {'OK' if grad_faces else 'FAIL'}"
            + (f"; cluster K={rs[0]['cluster']['K']} "
               f"C={rs[0]['cluster']['C']} depth="
               f"{rs[0]['cluster']['depth']} entry="
               f"{rs[0]['cluster']['entry']}" if backend == "cluster"
               else ""))
        for r in rs:
            f, st, gc = r["frame"], r["grad_step"], r["grad_check"]
            tr = f["transport"]
            log(f"  rank {r['rank']}: shard_s={r['shard_s']:.3f} "
                f"allocated_bytes={r['allocated_bytes']} frame_s="
                f"{f['seconds']:.4f} peak_mem_bytes={f['peak_mem_bytes']} "
                f"launches={f['launches']} hops="
                f"{tr['hops']} hop_bytes={tr['hop_bytes']} gathers="
                f"{tr['gathers']} staging_s={tr['staging_s']:.4f} "
                f"staged_bytes={tr['staged_bytes']} | 1080p vertex gradient "
                f"step_s={st['seconds']:.4f} peak_mem_bytes="
                f"{st['peak_mem_bytes']} hops={st['transport']['hops']} "
                f"staging_s={st['transport']['staging_s']:.4f} grad="
                f"{r['grad']} | 32x32 kernel vs plain loss_rel="
                f"{gc['loss_rel']:.3e} rel_l2={gc['rel_l2']} cos="
                f"{gc['cos']} {'OK' if r['ok'] else 'FAIL'}")
    return ok, out


def step_free_frame(params, cam, width, height):
    """A frame rendered in 2^21-pixel tiles (render_pixels)."""
    from visionaray_torch.sched.render import _render_frame
    return _render_frame(params, cam, width, height, "pathtracing", SPP,
                         "jittered_blend", 1 << 21, 2, nee=True)


def profile_run(run, label, table_path=None):
    """torch.profiler over one ``run()`` (a frame or a training step);
    prints the device busy share and the top kernels by device time and
    returns the numbers (``--profile`` runs it on the paths of phases
    3-20; phases 22-23 on each rank's frame).  ``--profile-table=PATH``
    also writes the profiler's full operator table to PATH."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies): an operator's row repeats
    # the time of the kernels it launched
    dev_rows = sorted((e for e in ka
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=dev_us, reverse=True)
    groups = {"traverse_kernel": ("binned_kernel", "coherent_kernel",
                                  "lbvh_kernel"),
              "volume_kernel": ("volume_kernel", "volume_bwd_kernel"),
              "sort": ("Sort", "sort", "Radix", "radix"),
              "gather_scatter": ("gather", "index", "scatter", "Index"),
              "reduce": ("reduce_kernel",),
              "cat_copy": ("Cat", "copy", "Memcpy", "Memset"),
              # NCCL's kernels run on their own stream, beside the
              # compute: with them the busy sum can exceed the wall time
              "nccl": ("nccl",)}
    sums = dict.fromkeys(list(groups) + ["elementwise_other"], 0.0)
    for e in dev_rows:
        g = next((k for k, keys in groups.items()
                  if any(s in e.key for s in keys)), "elementwise_other")
        sums[g] += dev_us(e) / 1e6
    busy_s = sum(sums.values())
    # the idle share is that of the compute stream: NCCL's kernels, on
    # their own stream, count as busy for as long as a rank waits in them
    idle = 1 - (busy_s - sums["nccl"]) / wall_s
    log(f"profile: {label} wall_s={wall_s:.4f} device_busy_s={busy_s:.4f} "
        f"idle_share={idle:.4f} (NCCL's stream left out) kernels_launched="
        f"{sum(e.count for e in dev_rows)} | "
        + " ".join(f"{k}={v:.4f}" for k, v in sums.items()))
    for e in dev_rows[:12]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  n={e.count:6d}  {e.key[:90]}")
    if table_path:
        sort_key = ("self_device_time_total"
                    if hasattr(dev_rows[0], "self_device_time_total")
                    else "self_cuda_time_total")
        with open(table_path, "w") as f:
            f.write(ka.table(sort_by=sort_key, row_limit=80))
    return dict(wall_s=wall_s, device_busy_s=busy_s, idle_share=idle,
                groups=sums)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a GPU only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    # ---- phase 1: build the kernel
    trav._library()
    info = trav.BUILD_INFO
    log(f"kernel build: {info['seconds']:.2f} s -> {info['path']}")
    for line in ptxas_lines(info["log"], main_path=True):
        log("  ptxas: " + line)
    spills = [n for n, f in ptxas_report(info["log"]).items() if f["spill"]]
    log(f"  forms with spills ({len(spills)} of "
        f"{len(ptxas_report(info['log']))}): {spills}")

    all_ok = True
    entries = []

    def check_modes(modes, rec, bvh, launches):
        ok = True
        for key, name, row in modes:
            if key not in rec.first:
                log(f"FAIL: mode {key} was never launched by its frame")
                ok = False
                continue
            good, entry = check_mode(key, name, row, rec.launches[key], bvh,
                                     launches)
            ok &= good
            entries.append(entry)
        return ok

    with torch.no_grad():
        # ---- phase 3 set-up: scene and BVH on the card
        t0 = time.perf_counter()
        scene, cam = sponza_like_scene(target_tris=TARGET_TRIS,
                                       build_bvh=False, device=dev)
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene.bvh = build_cluster_bvh(scene.mesh, cluster_size=K,
                                      treelet_size=T)
        torch.cuda.synchronize()
        bvh_build_s = time.perf_counter() - t0
        bvh = scene.bvh
        # the same build on the CPU (the tests hold the CPU build equal to
        # the JAX package's at small sizes)
        cpu_mesh = dataclasses.replace(scene.mesh,
                                       vertices=scene.mesh.vertices.cpu(),
                                       faces=scene.mesh.faces.cpu())
        cpu_bvh = build_cluster_bvh(cpu_mesh, cluster_size=K,
                                    treelet_size=T)
        same = all(torch.equal(getattr(bvh, k).cpu(), getattr(cpu_bvh, k))
                   for k in ("nodes", "tris", "treelet_lo", "treelet_hi",
                             "treelet_roots"))
        log(f"scene: tris={scene.num_triangles} scene_s={scene_s:.3f} "
            f"bvh_build_s={bvh_build_s:.3f} C={bvh.num_clusters} "
            f"K={bvh.cluster_size} S={bvh.num_treelets} "
            f"T={bvh.treelet_size} tables_equal_to_cpu_build={same}")
        all_ok &= same
        params = KernelParams.create(
            scene, num_bounces=BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        x, y = swizzled_pixels(dev)

        def frame(num):
            return render_pixels(params, cam, x, y, WIDTH, HEIGHT,
                                 "pathtracing", SPP, "jittered_blend", num,
                                 nee=True)

        # ---- phase 3: the forward frame, counts reset just before
        rec, launches, warm_s, times, color, depth = timed_frames(frame)
        log(f"warm frame: {warm_s:.3f} s, modes seen: {sorted(rec.first)}")
        frame_s = sum(times) / len(times)
        rays = WIDTH * HEIGHT * SPP * BOUNCES * 2
        hit_frac = float((depth > 0).float().mean())
        img_mean = float(color[:, :3].mean())
        finite = bool(torch.isfinite(color).all())
        img_std = float(color[:, :3].std())
        log(f"frame 1920x1080 spp=1 bounces=5 nee: frame_s={frame_s:.4f} "
            f"(frames {', '.join(f'{t:.4f}' for t in times)}) "
            f"mrays_per_s={rays / frame_s / 1e6:.3f} launches={launches} "
            f"entry_launches={rec.entries} "
            f"hit_fraction={hit_frac:.4f} image_mean={img_mean:.6f} "
            f"image_std={img_std:.6f} finite={finite}")
        coherent_n = sum(launches[k] for k in COHERENT)
        path_ok = (finite and img_std > 0 and hit_frac > 0.5
                   and all(launches[k] > 0 for k, _, _ in MODES)
                   and rec.entries["vsnray_traverse_coherent"] == coherent_n)
        if not path_ok:
            log("FAIL: the frame is not finite, is constant, hits too "
                "little, a path mode never launched, or a coherent mode "
                "did not run traverse_coherent.cu")
        all_ok &= path_ok

        # ---- phase 2: kernel vs plain, per mode, on captured launches
        all_ok &= check_modes(MODES, rec, bvh, launches)
        rec_entries = rec.entries
        del rec

        # ---- phase 4: whole-path check
        all_ok &= whole_path_check(dev)

    # ---- phase 5: the training step at full width
    step_ok, step_info = training_step_phase(params, cam, x, y)
    all_ok &= step_ok
    for e in entries:
        e["launches_training_step"] = step_info["forward_launches"].get(
            e["mode_key"], 0)

    # ---- phase 6: kernel vs plain gradients at 32x32
    all_ok &= grad_check(dev)

    with torch.no_grad():
        # ---- phase 7a: the radix tree of the 260k scene
        rbvh, rframe, tables_ok, rbuild_s = radix_phase(scene, cam,
                                                        cpu_mesh, dev)
        all_ok &= tables_ok
        rrec, rlaunches, rwarm_s, rtimes, rcolor, rdepth = \
            timed_frames(rframe)
        rframe_s = sum(rtimes) / len(rtimes)
        rfinite = bool(torch.isfinite(rcolor).all())
        rstd = float(rcolor[:, :3].std())
        rhit = float((rdepth > 0).float().mean())
        radix_ok = (rfinite and rstd > 0 and rhit > 0.5
                    and all(rlaunches[k] > 0 for k, _, _ in RADIX_MODES)
                    and sum(rlaunches.values()) == sum(
                        rlaunches[k] for k, _, _ in RADIX_MODES)
                    and rrec.entries["vsnray_traverse_binned"] == sum(
                        rlaunches.values()))
        log(f"radix frame 1920x1080 spp=1 bounces=5 nee: "
            f"frame_s={rframe_s:.4f} (frames "
            f"{', '.join(f'{t:.4f}' for t in rtimes)}) warm_s={rwarm_s:.3f} "
            f"mrays_per_s={rays / rframe_s / 1e6:.3f} launches={rlaunches} "
            f"entry_launches={rrec.entries} "
            f"hit_fraction={rhit:.4f} image_mean="
            f"{float(rcolor[:, :3].mean()):.6f} image_std={rstd:.6f} "
            f"finite={rfinite} {'OK' if radix_ok else 'FAIL'}")
        all_ok &= radix_ok
        all_ok &= check_modes(RADIX_MODES, rrec, rbvh, rlaunches)
        rentries = rrec.entries
        del rrec

        # ---- phase 7b: a single-cluster tree (C == 1)
        c1, c1_cam = c1_scene(dev)
        c1_params = KernelParams.create(
            c1, num_bounces=2, epsilon=1e-3, bg_color=(0.2, 0.3, 0.5, 1.0),
            ambient_color=(1.0, 1.0, 1.0, 1.0))
        cx, cy = _pixel_grid(64, 64, dev)

        def c1_frame(num):
            return render_pixels(c1_params, c1_cam, cx, cy, 64, 64,
                                 "pathtracing", 1, "jittered_blend", num,
                                 nee=True)

        crec, claunches, _, _, ccolor, cdepth = timed_frames(c1_frame)
        c1_ok = (c1.bvh.num_clusters == 1 and bool(
            torch.isfinite(ccolor).all()) and float(ccolor.std()) > 0
            and all(claunches[k] > 0 for k, _, _ in C1_MODES))
        log(f"C == 1 frame 64x64 bounces=2 nee: tris={c1.num_triangles} "
            f"C={c1.bvh.num_clusters} launches={claunches} hit_fraction="
            f"{float((cdepth > 0).float().mean()):.4f} "
            f"{'OK' if c1_ok else 'FAIL'}")
        all_ok &= c1_ok
        all_ok &= check_modes(C1_MODES, crec, c1.bvh, claunches)
        del crec

        # ---- phase 7c: the simple frame on the radix tree, render's
        # defaults only; then on the radix tree at K=40
        simple = {}
        for label, sbvh in (("", rbvh), ("_k40", None)):
            if sbvh is None:
                sbvh = build_cluster_bvh(scene.mesh, cluster_size=40,
                                         treelet_size=0)
            ok, simple[f"simple_frame{label}_s"] = simple_phase(
                dataclasses.replace(scene, bvh=sbvh), cam, label,
                check_modes)
            all_ok &= ok

    with torch.no_grad():
        # ---- phase 8: row 1f, the four options on the main path's frame
        frames_1f = {}
        for option, cfg in OPTIONS_1F.items():
            first = len(entries)
            good, frames_1f[option] = option_phase(
                option, cfg, params, cam, x, y, color, check_modes)
            for e in entries[first:]:
                e["option"] = option
            all_ok &= good

    # ---- phase 8: the training step under one 1f option
    cfg = OPTIONS_1F[STEP_1F]
    step_ok, step_1f = training_step_phase(
        dataclasses.replace(params, trace=cfg), cam, x, y,
        label=f"1f {STEP_1F} training step")
    forms = {trav.variant_key(k, cfg.fanout, cfg.half_skip)
             for k, _, _ in MODES}
    step_ok &= set(step_1f["forward_variants"]) == forms
    all_ok &= step_ok
    for e in entries:
        if e.get("option") == STEP_1F:
            e["launches_training_step"] = step_1f["forward_variants"].get(
                e["variant"], 0)
        elif e.get("option"):
            e["launches_training_step"] = 0

    with torch.no_grad():
        # ---- phase 9: the shadow and sort-key switches
        switch_frames = {}
        for name, (cfg, expect) in SWITCHES.items():
            first = len(entries)
            good, switch_frames[name] = switch_phase(
                name, cfg, expect, params, cam, x, y, color, check_modes)
            for e in entries[first:]:
                e["switch"] = name
                e["launches_training_step"] = 0
            all_ok &= good

    # ---- phases 10-13: render's other paths on phase 7a's radix tree
    rscene = dataclasses.replace(scene, bvh=rbvh)
    slice7 = {}
    first = len(entries)
    with torch.no_grad():
        for algo in ("whitted", "ao"):
            good, slice7[f"{algo}_frame"] = algo_phase(rscene, cam, algo,
                                                       check_modes)
            all_ok &= good
    good, slice7["boundary_step"] = boundary_phase(rscene, cam, check_modes,
                                                   dev)
    all_ok &= good
    with torch.no_grad():
        good, slice7["filter_multi_hit"] = filter_phase(rscene, cam,
                                                        check_modes, dev)
    all_ok &= good
    for e in entries[first:]:
        e["launches_training_step"] = 0

    # ---- phases 14-16: the LBVH tier (traverse_lbvh.cu)
    slice8 = {}
    good, slice8["lbvh"], lscene, lcam = lbvh_phase(cpu_mesh, dev, entries)
    all_ok &= good
    with torch.no_grad():
        all_ok &= whole_path_check(dev, lbvh=True)
    all_ok &= grad_check(dev, lbvh=True)
    good, slice8["builders"] = builders_phase(lscene, lcam, entries)
    all_ok &= good
    good, slice8["spheres"] = sphere_phase(dev, entries)
    all_ok &= good
    flat8 = {k: v for part in slice8.values() for k, v in part.items()
             if k.endswith("_s") or k.endswith("_cost")}

    # ---- phases 17-19: textures, spectral rendering, volumes
    slice9 = {}
    with torch.no_grad():
        good, slice9["textures"], tscene, tcam, tparams, tx, ty = \
            texture_phase(dev, entries)
        all_ok &= good
        good, slice9["spectral"] = spectral_phase(
            scene, cam, params, x, y, color, dev, entries, check_modes)
        all_ok &= good
        ptx = ptxas_report(info["log"])
        sass = {name: step_loop(ins)
                for name, ins in kernel_sass(info["path"]).items()
                if name.startswith("volume count=")}
        vscene, vcam = volume_scene(VOLUME_RES, device=dev)
        good, slice9["volume"] = volume_phase("volume", vscene, vcam, dev,
                                              entries, ptx, sass)
        all_ok &= good
        mscene, mcam = multi_volume_scene(MULTI_RES, MULTI_N, device=dev)
        good, slice9["multi_volume"] = volume_phase(
            "multi volume", mscene, mcam, dev, entries, ptx, sass)
        all_ok &= good
        del mscene
    flat9 = {k: v for part in ("textures", "spectral")
             for k, v in slice9[part].items()
             if k.endswith(("_s", "_bytes", "_tile"))}
    flat9.update(volume_frame_s=slice9["volume"]["frame_s"],
                 multi_volume_frame_s=slice9["multi_volume"]["frame_s"])

    # ---- phase 20: the volume march's backward kernel, the volume step
    slice10 = {}
    good, slice10["volume_grad"], vstep = volume_grad_phase(
        "volume", vscene, vcam, dev, entries, ptx)
    all_ok &= good
    mscene, mcam = multi_volume_scene(MULTI_RES, MULTI_N, device=dev)
    good, slice10["multi_volume_grad"], _ = volume_grad_phase(
        "multi volume", mscene, mcam, dev, entries, ptx)
    all_ok &= good
    del mscene

    # ---- phase 21: the port's CLI at full width
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        good, slice10["cli"] = cli_phase(dev, tmp)
    all_ok &= good
    # ---- phases 22-23: parallel/, ranks spawned here (the library is
    # built: they load it)
    slice11 = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        good, slice11["tile"] = tile_phase(params, cam, dev, tmp)
        all_ok &= good
        good, slice11["config5"] = config5_phase(dev, tmp, entries)
        all_ok &= good
    flat10 = {"volume_step_s": slice10["volume_grad"]["step_s"],
              "multi_volume_step_s":
                  slice10["multi_volume_grad"]["step_s"],
              **{f"cli_{k}_wall_s": v["wall_s"]
                 for k, v in slice10["cli"].items()}}

    if "--profile" in sys.argv[1:]:
        table = [a.split("=", 1)[1] for a in sys.argv[1:]
                 if a.startswith("--profile-table=")]
        with torch.no_grad():
            profile_run(lambda: frame(TIMED_FRAMES + 2), "frame",
                        table[0] if table else None)
            profile_run(lambda: rframe(TIMED_FRAMES + 2), "radix frame")
        profile_run(lambda: step.loss_and_grads(
            params.scene.mesh.vertices, params.scene.materials.cd,
            TIMED_STEPS + 3, params, cam, x, y, nee=True), "training step",
            table[0] + ".step" if table else None)
        with torch.no_grad():
            for algo in ("whitted", "ao"):
                profile_run(lambda: render(rscene, cam, WIDTH, HEIGHT,
                                           algo=algo), f"{algo} frame")
        adj = build_edge_adjacency(rscene.mesh.faces.cpu().numpy(),
                                   rscene.mesh.vertices.cpu().numpy(),
                                   device=dev)
        profile_run(lambda: _boundary_grad(rscene, cam, WIDTH, HEIGHT, adj),
                    "boundary step")
        lparams = KernelParams.create(
            lscene, num_bounces=BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        with torch.no_grad():
            profile_run(lambda: render(lscene, lcam, WIDTH, HEIGHT),
                        "lbvh simple frame")
            profile_run(lambda: render_pixels(
                lparams, lcam, x, y, WIDTH, HEIGHT, "pathtracing", SPP,
                "jittered_blend", TIMED_FRAMES + 2, nee=True),
                "lbvh nee frame")
        profile_run(lambda: step.loss_and_grads(
            lscene.mesh.vertices, lscene.materials.cd, TIMED_STEPS + 3,
            lparams, lcam, x, y, nee=True), "lbvh training step")
        with torch.no_grad():
            profile_run(lambda: render(vscene, vcam, WIDTH, HEIGHT,
                                       algo="volume"), "volume frame")
            profile_run(lambda: render_pixels(
                tparams, tcam, tx, ty, WIDTH, HEIGHT, "pathtracing", SPP,
                "jittered_blend", TIMED_FRAMES + 2, nee=True),
                "tex nee frame")
        profile_run(vstep, "volume step")

    log(json.dumps({"kernels": entries, "frame_s": frame_s,
                    "entry_launches": rec_entries,
                    "bvh_build_s": bvh_build_s,
                    "mrays_per_s": rays / frame_s / 1e6,
                    "training_step": step_info,
                    "radix_frame_s": rframe_s,
                    "radix_entry_launches": rentries, **simple,
                    "radix_bvh_build_s": rbuild_s,
                    "frames_1f": frames_1f, "training_step_1f": step_1f,
                    "switch_frames": switch_frames, **slice7,
                    **flat8, "lbvh_slice": slice8, **flat9,
                    "slice9": slice9, **flat10, "slice10": slice10,
                    "slice11": slice11,
                    "build_s": info["seconds"]}))
    log(f"card: {smi}")
    if not all_ok:
        log("chip_smoke: FAILED")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2:]))
    sys.exit(main())
