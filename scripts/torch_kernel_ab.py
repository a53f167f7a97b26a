"""A/B of versions of the port's traversal kernels on one GPU.

    python3 scripts/torch_kernel_ab.py NAME=PATH[,FLAG...] [NAME=PATH ...]

PATH is a kernel source (.cu) or a directory of them (the port's
``visionaray_torch/ops/cuda``, or a parent's, unpacked with ``git archive``
into the git-ignored ``build/``); FLAGs are extra nvcc flags, e.g.
``-DNAME=VALUE``.  Every version is built with the port's nvcc flags, all
builds at once.  The script captures every traversal launch of
chip_smoke.py's 1080p frame (modes 1, 1b, 1c, 1d), the mode-1d launches of
the same frame under TraceConfig(shadow_binned=False) (bounce 0's shadows,
then bounces 1-4's, incoherent), and the coherent launches (modes 1, 1d)
of the frame under each 1f option of chip_smoke.OPTIONS_1F, and times every
version on each of them in turns (ROUNDS rounds, the order rotated each
round), each launch in the form it was captured with.  A version with
``vsnray_traverse_coherent`` routes launches as ``launch_form`` does; an
older one sends the two-pass launches to ``vsnray_traverse_binned`` where
it has it and everything else to ``vsnray_traverse``.  Prints:

- per group of launches, the least and the mean over rounds of the first
  launch's ms and of the ms summed over the group's launches;
- each version's outputs against the first version's on every launch:
  closest-hit t bit-equal on every live lane, the lanes whose prim differs
  (then at equal t: a tie), u and v equal where the prims agree; any-hit
  hit flags equal;
- the default frame rendered through each version, its image against the
  first version's (chip_smoke.py's image tolerances);
- registers, shared memory and spills (ptxas) of each version's main-path
  forms, and whether the SASS of each non-counting radix form
  (traverse.cu) and two-pass form (traverse_binned.cu) equals the first
  version's.
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
from visionaray_torch.sched.render import render_pixels  # noqa: E402

BUILD = Path(__file__).resolve().parents[1] / "build" / "kernel_ab"
ROUNDS = 4


def sass_key(name):
    """A readable key of a non-counting radix or two-pass kernel form, from
    its SASS function name (the radix forms of a tree before traverse.cu
    was cut to them carry heap=0, fanout 2, no half skip), else None."""
    m = re.search(r"traverse_kernelILb(\d)ELb0E(?:Lb0ELi2ELb0E)?E", name)
    if m:
        return f"radix any={m.group(1)}"
    m = re.search(r"binned_kernelILb(\d)ELb0ELi(\d)ELb(\d)ELi(\d+)E", name)
    if m:
        return "binned any={} fanout={} half={} K={}".format(*m.groups())
    return None


class Version:
    """One built version: its library and what its entry points take."""

    def __init__(self, name, spec):
        path, *flags = spec.split(",")
        path = Path(path)
        self.name = name
        self.sources = sorted(path.glob("*.cu")) if path.is_dir() else [path]
        text = "".join(p.read_text() for p in self.sources)
        self.coherent = "vsnray_traverse_coherent" in text
        self.binned = "vsnray_traverse_binned" in text
        self.dir = BUILD / name
        self.flags = [*trav.NVCC_FLAGS, *flags]

    def build(self):
        so = trav.build_library(self.sources, self.dir, self.flags)
        self.log = (self.dir / "nvcc.log").read_text()
        if self.coherent:
            self.lib = trav.bind_library(so)
        else:
            # the layout before traverse_coherent.cu: vsnray_traverse takes
            # heap, fanout and half_skip
            self.lib = ctypes.CDLL(str(so))
            self.lib.vsnray_traverse.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])
            self.lib.vsnray_traverse.restype = ctypes.c_int
            if self.binned:
                self.lib.vsnray_traverse_binned.argtypes = (
                    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])
                self.lib.vsnray_traverse_binned.restype = ctypes.c_int
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
        if self.coherent:
            entry = trav.launch_form(True, C, two_pass, bool(any_hit),
                                     fanout, bool(half), K)[0]
        elif self.binned and two_pass:
            entry = "vsnray_traverse_binned"
        else:
            entry = "vsnray_traverse"
        if entry == "vsnray_traverse_coherent":
            args = [*head, *tail, npad, C, K, any_hit]
        elif entry == "vsnray_traverse_binned":
            args = [*head, *tiles, *tail, npad, npad // tl, tl, C, K, any_hit,
                    fanout, half]
        else:   # the heap forms of traverse.cu before traverse_coherent.cu
            args = [*head, *tiles, *tail, npad, npad // tl, tl, C, K, any_hit,
                    1, fanout, half]
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
        for kind in ("radix", "binned"):
            keys = sorted(k for k in v.sass if k.startswith(kind))
            same = [k for k in keys if first.sass.get(k) == v.sass[k]]
            print(f"{v.name}: SASS of {len(keys)} non-counting {kind} forms; "
                  f"equal to {first.name}'s: {len(same)}/{len(keys)}"
                  + ("" if len(same) == len(keys) else
                     f" (differ: {sorted(set(keys) - set(same))[:8]})"))
        for line in cs.ptxas_lines(v.log, main_path=True):
            print(f"  {v.name} ptxas {line}")

    dev = torch.device("cuda")
    with torch.no_grad():
        scene, cam = sponza_like_scene(target_tris=cs.TARGET_TRIS, device=dev)
        scene.bvh = bvh = build_cluster_bvh(scene.mesh, cluster_size=cs.K,
                                            treelet_size=cs.T)
        params = KernelParams.create(
            scene, num_bounces=cs.BOUNCES, epsilon=1e-3,
            bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
        x, y = cs.swizzled_pixels(dev)

        def frame(cfg=TraceConfig()):
            p = dataclasses.replace(params, trace=cfg)
            return render_pixels(p, cam, x, y, cs.WIDTH, cs.HEIGHT,
                                 "pathtracing", cs.SPP, "jittered_blend", 1,
                                 nee=True)

        def capture(cfg, keys):
            rec = cs.LaunchRecorder(trav.cluster_traverse)
            with cs.recorded(rec):
                frame(cfg)
            return {k: rec.launches[k] for k in keys}

        # (label, mode key, launches)
        groups = []
        default = capture(TraceConfig(), [k for k, _, _ in cs.MODES])
        groups += [(f"{row} ({key})", key, default[key])
                   for key, _, row in cs.MODES]
        shadows = capture(TraceConfig(shadow_binned=False), ["any"])["any"]
        groups.append(("1d shadow_binned=False, bounce 0", "any",
                       shadows[:1]))
        groups.append(("1d shadow_binned=False, bounces 1-4 (incoherent)",
                       "any", shadows[1:]))
        for option, cfg in cs.OPTIONS_1F.items():
            got = capture(cfg, cs.COHERENT)
            groups += [(f"1f {option} {key}", key, got[key])
                       for key in cs.COHERENT]
        for label, _, lns in groups:
            print(f"{label}: {len(lns)} launches, live lanes "
                  f"{[int((ln['rays'][:, 6] >= 0).sum()) for ln in lns]}")

        first_ms, sum_ms = {}, {}
        for rnd in range(ROUNDS):
            for v in versions[rnd % len(versions):] + \
                    versions[:rnd % len(versions)]:
                for label, _, lns in groups:
                    times = [cs.cuda_ms(lambda: v.call(ln, bvh), 3)
                             for ln in lns]
                    first_ms.setdefault((label, v.name), []).append(times[0])
                    sum_ms.setdefault((label, v.name), []).append(sum(times))
        for label, _, lns in groups:
            for what, table in (("first launch", first_ms),
                                (f"sum of {len(lns)} launches", sum_ms)):
                print(f"{label} ms, {what}, least/mean of {ROUNDS}: "
                      + "  ".join(
                          f"{v.name}={min(table[(label, v.name)]):.4f}/"
                          f"{sum(table[(label, v.name)]) / ROUNDS:.4f}"
                          for v in versions))

        for v in versions[1:]:
            for label, key, lns in groups:
                equal, prim_diff = True, 0
                for ln in lns:
                    e, p = compare(v.call(ln, bvh), first.call(ln, bvh),
                                   ln["rays"], ln["any_hit"])
                    equal &= e
                    prim_diff += p
                print(f"{v.name} vs {first.name}, {label}: "
                      + ("hit flags equal" if key == "any"
                         else "t equal on live lanes, u, v equal where "
                              "prims agree")
                      + f": {equal}" + ("" if key == "any" else
                                        f"; lanes whose prim differs "
                                        f"(a tie at equal t): {prim_diff}"))
        images = {}
        real = trav.cluster_traverse
        for v in versions:
            trav.cluster_traverse = v.traverse(bvh)
            try:
                images[v.name] = frame()[0]
            finally:
                trav.cluster_traverse = real
        for v in versions[1:]:
            mean_abs, share = cs.image_diff(images[v.name], images[first.name])
            ok = mean_abs <= cs.IMG_MEAN_ABS and share <= cs.IMG_PIX_SHARE
            print(f"{v.name} vs {first.name}: default frame image mean_abs="
                  f"{mean_abs:.3e} pixels_over_{cs.IMG_PIX_TOL:g}={share:.4f} "
                  f"{'OK' if ok else 'FAIL'}")
    print(f"card: {cs.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
