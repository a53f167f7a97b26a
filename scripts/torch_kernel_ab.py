"""A/B of versions of the port's traversal kernels on one GPU.

    python3 scripts/torch_kernel_ab.py NAME=PATH[,FLAG...] [NAME=PATH ...]

PATH is a kernel source (.cu) or a directory of them (the port's
``visionaray_torch/ops/cuda``, or a parent's, unpacked with ``git archive``
into the git-ignored ``build/``); FLAGs are extra nvcc flags, e.g.
``-DNAME=VALUE``.  Every version is built with the port's nvcc flags, all
builds at once.  The script captures every traversal launch of
chip_smoke.py's 1080p frame (modes 1, 1b, 1c, 1d), the mode-1d launches of
the same frame under TraceConfig(shadow_binned=False) (bounce 0's shadows,
then bounces 1-4's, incoherent), the coherent launches (modes 1, 1d) of
the frame under each 1f option of chip_smoke.OPTIONS_1F, every launch of
the radix frame (chip_smoke.py phase 7a: the same frame on the scene's
radix tree, modes radix_closest and radix_any), the simple frame's one
launch on that tree (phase 7c) and the C == 1 frame's launches (phase
7b), and times every version on each of them in turns (ROUNDS rounds, the
order rotated each round), each launch in the form it was captured with.
A version routes launches as ``launch_form`` does; one that still has
``vsnray_traverse`` (traverse.cu, before the radix trees moved to the
other two kernels) sends the radix launches there.  Prints:

- per group of launches, the least and the mean over rounds of the first
  launch's ms and of the ms summed over the group's launches;
- each version's outputs against the first version's on every launch:
  closest-hit t bit-equal on every live lane, the lanes whose prim differs
  (then at equal t: a tie), u and v equal where the prims agree; any-hit
  hit flags equal;
- the default frame rendered through each version, its image against the
  first version's (chip_smoke.py's image tolerances);
- registers, shared memory and spills (ptxas) of each version's main-path
  forms, and whether the SASS of each heap-tree form of
  traverse_coherent.cu (counting ones too) and each non-counting heap-tree
  form of traverse_binned.cu equals the first version's (and of each
  radix form, where the first version has it).
"""

import ctypes
import dataclasses
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import visionaray_torch.ops.traverse as trav  # noqa: E402
from visionaray_torch.kernels.params import KernelParams  # noqa: E402
from visionaray_torch.ops.cluster_bvh import build_cluster_bvh  # noqa: E402
from visionaray_torch.ops.trace import TraceConfig  # noqa: E402
from visionaray_torch.scenes.sponza_like import sponza_like_scene  # noqa: E402
from visionaray_torch.sched.render import (  # noqa: E402
    _pixel_grid, render, render_pixels,
)

BUILD = Path(__file__).resolve().parents[1] / "build" / "kernel_ab"
ROUNDS = 4


def sass_key(name):
    """A readable key of a kernel form whose SASS is compared, from its SASS
    function name: every coherent form, the non-counting two-pass forms,
    the non-counting radix forms (traverse.cu's, or traverse_binned.cu's
    with kHeap false); two-pass forms from before the kernel took
    ``kHeap`` are heap forms.  Else None."""
    m = re.search(r"traverse_kernelILb(\d)ELb0EE", name)
    if m:
        return f"radix any={m.group(1)}"
    m = re.search(r"coherent_kernelILb(\d)ELb(\d)ELi(\d+)E", name)
    if m:
        return "coherent any={} count={} K={}".format(*m.groups())
    m = re.search(r"binned_kernelILb(\d)ELb0ELi(\d)ELb(\d)ELi(\d+)E"
                  r"(?:Lb(\d)E)?", name)
    if m:
        kind = "binned" if m.group(5) in (None, "1") else "binned-radix"
        return "{} any={} fanout={} half={} K={}".format(kind,
                                                          *m.groups()[:4])
    return None


class Version:
    """One built version: its library and what its entry points take."""

    def __init__(self, name, spec):
        path, *flags = spec.split(",")
        path = Path(path)
        self.name = name
        self.sources = sorted(path.glob("*.cu")) if path.is_dir() else [path]
        text = "".join(p.read_text() for p in self.sources)
        # traverse.cu's entry: radix trees there, no heap arguments elsewhere
        self.radix_entry = 'extern "C" int vsnray_traverse(' in text
        self.dir = BUILD / name
        self.flags = [*trav.NVCC_FLAGS, *flags]

    def build(self):
        so = trav.build_library(self.sources, self.dir, self.flags)
        self.log = (self.dir / "nvcc.log").read_text()
        if self.radix_entry:
            self.lib = ctypes.CDLL(str(so))
            p, i = ctypes.c_void_p, ctypes.c_int
            for entry, argtypes in (
                    ("vsnray_traverse", [p] * 10 + [i] * 6 + [p]),
                    ("vsnray_traverse_binned", [p] * 10 + [i] * 8 + [p]),
                    ("vsnray_traverse_coherent", [p] * 8 + [i] * 4 + [p])):
                getattr(self.lib, entry).argtypes = argtypes
                getattr(self.lib, entry).restype = ctypes.c_int
        else:
            self.lib = trav.bind_library(so)
        cuobjdump = Path(trav._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
        self.sass = {}
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            key = sass_key(body.split("\n", 1)[0])
            if key:
                self.sass[key] = [
                    re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0]
                    .strip() for line in body.splitlines()
                    if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
        return self

    def call(self, launch, bvh):
        """One launch in the form it was captured with."""
        rays, roots, splits, tl = cs.full_tiles(launch)
        npad = rays.shape[0]
        dev = rays.device
        C, K = bvh.num_clusters, bvh.cluster_size
        two_pass = launch["roots"] is not None
        fanout, half = launch["fanout"], int(launch["half_skip"])
        any_hit = int(launch["any_hit"])
        outs = [torch.empty(npad, device=dev) for _ in range(4)]
        head = [rays.data_ptr(), bvh.nodes.data_ptr(), bvh.tris.data_ptr()]
        tiles = [roots.data_ptr(), splits.data_ptr()]
        tail = [*[o.data_ptr() for o in outs], None]
        stream = torch.cuda.current_stream().cuda_stream
        heap = [] if self.radix_entry else [int(bvh.heap)]
        entry = trav.launch_form(bvh.heap, C, two_pass, bool(any_hit),
                                 fanout, bool(half), K)[0]
        if self.radix_entry and not bvh.heap:
            entry = "vsnray_traverse"
        if entry == "vsnray_traverse_coherent":
            args = [*head, *tail, npad, C, K, any_hit]
        elif entry == "vsnray_traverse_binned":
            args = [*head, *tiles, *tail, npad, npad // tl, tl, C, K, any_hit,
                    fanout, half, *heap]
        else:   # traverse.cu's radix forms
            args = [*head, *tiles, *tail, npad, npad // tl, tl, C, K, any_hit]
        err = getattr(self.lib, entry)(*args, stream)
        if err:
            raise RuntimeError(f"{self.name}: {entry} failed, cudaError "
                               f"{err}")
        return outs

    def traverse(self, bvh):
        """A stand-in for cluster_traverse that launches this version."""
        def run(rays, nodes, tris, num_clusters, cluster_size, tile_lanes,
                any_hit=False, tile_roots=None, tile_splits=None,
                counters=None, heap=True, depth=None, fanout=2,
                half_skip=False):
            return tuple(self.call(dict(
                rays=rays, tile_lanes=tile_lanes, any_hit=any_hit,
                roots=tile_roots, splits=tile_splits, fanout=fanout,
                half_skip=half_skip), bvh))
        return run


def compare(a, b, rays, any_hit):
    """(equal, lanes whose prim differs) of outputs a against b."""
    live = rays[:, 6] >= 0
    if any_hit:
        return torch.equal(a[1] >= 0, b[1] >= 0), 0
    same_t = torch.equal(a[0][live], b[0][live])
    same_p = a[1] == b[1]
    uv = all(torch.equal(x[same_p], y[same_p]) for x, y in zip(a[2:], b[2:]))
    return same_t and uv, int((live & ~same_p).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    versions = [Version(*a.split("=", 1)) for a in sys.argv[1:]]
    with ThreadPoolExecutor(len(versions)) as pool:
        versions = list(pool.map(Version.build, versions))
    first = versions[0]
    for v in versions:
        for kind in ("coherent", "binned", "radix", "binned-radix"):
            keys = sorted(k for k in v.sass if k.split(" ")[0] == kind)
            if not keys:
                continue
            same = [k for k in keys if first.sass.get(k) == v.sass[k]]
            print(f"{v.name}: SASS of {len(keys)} {kind} forms; equal to "
                  f"{first.name}'s: {len(same)}/{len(keys)}"
                  + ("" if len(same) == len(keys) else
                     f" (differ: {sorted(set(keys) - set(same))[:8]})"))
        for line in cs.ptxas_lines(v.log, main_path=True):
            print(f"  {v.name} ptxas {line}")

    dev = torch.device("cuda")
    with torch.no_grad():
        scene, cam = sponza_like_scene(target_tris=cs.TARGET_TRIS,
                                       build_bvh=False, device=dev)
        scene.bvh = bvh = build_cluster_bvh(scene.mesh, cluster_size=cs.K,
                                            treelet_size=cs.T)
        radix = dataclasses.replace(scene, bvh=build_cluster_bvh(
            scene.mesh, treelet_size=0))
        params = KernelParams.create(
            scene, num_bounces=cs.BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        x, y = cs.swizzled_pixels(dev)
        c1, c1_cam = cs.c1_scene(dev)
        cx, cy = _pixel_grid(64, 64, dev)

        def frame(cfg=TraceConfig(), s=scene):
            p = dataclasses.replace(params, scene=s, trace=cfg)
            return render_pixels(p, cam, x, y, cs.WIDTH, cs.HEIGHT,
                                 "pathtracing", cs.SPP, "jittered_blend", 1,
                                 nee=True)

        def c1_frame():
            p = dataclasses.replace(params, scene=c1, num_bounces=2)
            return render_pixels(p, c1_cam, cx, cy, 64, 64, "pathtracing", 1,
                                 "jittered_blend", 1, nee=True)

        def capture(run, keys):
            rec = cs.LaunchRecorder(trav.cluster_traverse)
            with cs.recorded(rec):
                run()
            return {k: rec.launches[k] for k in keys}

        # (label, launches, tree)
        groups = []
        default = capture(frame, [k for k, _, _ in cs.MODES])
        groups += [(f"{row} ({key})", default[key], bvh)
                   for key, _, row in cs.MODES]
        shadows = capture(lambda: frame(TraceConfig(shadow_binned=False)),
                          ["any"])["any"]
        groups.append(("1d shadow_binned=False, bounce 0", shadows[:1], bvh))
        groups.append(("1d shadow_binned=False, bounces 1-4 (incoherent)",
                       shadows[1:], bvh))
        for option, cfg in cs.OPTIONS_1F.items():
            got = capture(lambda: frame(cfg), cs.COHERENT)
            groups += [(f"1f {option} {key}", got[key], bvh)
                       for key in cs.COHERENT]
        got = capture(lambda: frame(s=radix), ("radix_closest", "radix_any"))
        groups += [(f"1e radix frame {key}", got[key], radix.bvh)
                   for key in got]
        got = capture(lambda: render(radix, cam, cs.WIDTH, cs.HEIGHT),
                      ("radix_closest",))
        groups.append(("1e simple frame radix_closest", got["radix_closest"],
                       radix.bvh))
        got = capture(c1_frame, ("c1_closest", "c1_any"))
        groups += [(f"1e C == 1 frame {key}", got[key], c1.bvh)
                   for key in got]
        for label, lns, _ in groups:
            print(f"{label}: {len(lns)} launches, live lanes "
                  f"{[int((ln['rays'][:, 6] >= 0).sum()) for ln in lns]}")

        first_ms, sum_ms = {}, {}
        for rnd in range(ROUNDS):
            for v in versions[rnd % len(versions):] + \
                    versions[:rnd % len(versions)]:
                for label, lns, tree in groups:
                    times = [cs.cuda_ms(lambda: v.call(ln, tree), 3)
                             for ln in lns]
                    first_ms.setdefault((label, v.name), []).append(times[0])
                    sum_ms.setdefault((label, v.name), []).append(sum(times))
        for label, lns, _ in groups:
            for what, table in (("first launch", first_ms),
                                (f"sum of {len(lns)} launches", sum_ms)):
                print(f"{label} ms, {what}, least/mean of {ROUNDS}: "
                      + "  ".join(
                          f"{v.name}={min(table[(label, v.name)]):.4f}/"
                          f"{sum(table[(label, v.name)]) / ROUNDS:.4f}"
                          for v in versions))

        for v in versions[1:]:
            for label, lns, tree in groups:
                equal, prim_diff = True, 0
                any_hit = lns[0]["any_hit"]
                for ln in lns:
                    e, p = compare(v.call(ln, tree), first.call(ln, tree),
                                   ln["rays"], any_hit)
                    equal &= e
                    prim_diff += p
                print(f"{v.name} vs {first.name}, {label}: "
                      + ("hit flags equal" if any_hit
                         else "t equal on live lanes, u, v equal where "
                              "prims agree")
                      + f": {equal}" + ("" if any_hit else
                                        f"; lanes whose prim differs "
                                        f"(a tie at equal t): {prim_diff}"))
        images = {}
        real = trav.cluster_traverse
        for v in versions:
            for name, s in (("default", scene), ("radix", radix)):
                trav.cluster_traverse = v.traverse(s.bvh)
                try:
                    images[name, v.name] = frame(s=s)[0]
                finally:
                    trav.cluster_traverse = real
        for v in versions[1:]:
            for name in ("default", "radix"):
                mean_abs, share = cs.image_diff(images[name, v.name],
                                                images[name, first.name])
                ok = mean_abs <= cs.IMG_MEAN_ABS and share <= cs.IMG_PIX_SHARE
                print(f"{v.name} vs {first.name}: {name} frame image "
                      f"mean_abs={mean_abs:.3e} pixels_over_"
                      f"{cs.IMG_PIX_TOL:g}={share:.4f} "
                      f"{'OK' if ok else 'FAIL'}")
    print(f"card: {cs.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
