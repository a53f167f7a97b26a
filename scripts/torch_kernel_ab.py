"""A/B of versions of the port's traversal kernels on one GPU.

    python3 scripts/torch_kernel_ab.py NAME=PATH[,FLAG...] [NAME=PATH ...]

PATH is a kernel source (.cu) or a directory of them (the port's
``visionaray_torch/ops/cuda``, or a parent's, unpacked with ``git archive``
into the git-ignored ``build/``); FLAGs are extra nvcc flags, e.g.
``-DNAME=VALUE``.  Every version is built with the port's nvcc flags, all
builds at once.  The script captures every traversal launch of
chip_smoke.py's 1080p frame (modes 1, 1b, 1c, 1d) and times every version
on each of them in turns (ROUNDS rounds, the order rotated each round), in
the main path's form (binary descent, no half-cluster skip); a version with
``vsnray_traverse_binned`` takes the two-pass launches there.  Prints:

- per mode, the least and the mean over rounds of the first launch's ms
  and of the ms summed over the frame's launches (24 of 1b, 12 of 1c);
- whether each version's outputs equal the first version's on every launch
  (closest-hit: t, prim, u, v; any-hit: the hit flag);
- registers, shared memory and spills (ptxas) of each version's main-path
  forms, and whether the SASS of each non-counting traverse.cu form
  (coherent and radix) equals the first version's.
"""

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
from visionaray_torch.scenes.sponza_like import sponza_like_scene  # noqa: E402
from visionaray_torch.sched.render import render_pixels  # noqa: E402

BUILD = Path(__file__).resolve().parents[1] / "build" / "kernel_ab"
ROUNDS = 4
BINNED = ("binned_closest", "binned_any")


class Version:
    """One built version: its library and what its entry points take."""

    def __init__(self, name, spec):
        path, *flags = spec.split(",")
        path = Path(path)
        self.name = name
        self.sources = sorted(path.glob("*.cu")) if path.is_dir() else [path]
        text = "".join(p.read_text() for p in self.sources)
        self.wide = "int half_skip" in text       # takes fanout, half_skip
        self.binned = "vsnray_traverse_binned" in text
        self.dir = BUILD / name
        self.flags = [*trav.NVCC_FLAGS, *flags]

    def build(self):
        so = trav.build_library(self.sources, self.dir, self.flags)
        self.log = (self.dir / "nvcc.log").read_text()
        if self.binned:
            self.lib = trav.bind_library(so)
        else:
            import ctypes
            self.lib = ctypes.CDLL(str(so))
            self.lib.vsnray_traverse.argtypes = (
                [ctypes.c_void_p] * 10
                + [ctypes.c_int] * (9 if self.wide else 7)
                + [ctypes.c_void_p])
            self.lib.vsnray_traverse.restype = ctypes.c_int
        cuobjdump = Path(trav._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
        self.sass = {}
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            m = re.search(r"traverse_kernelILb(\d)ELb(\d)ELb(\d)E"
                          r"(?:Li(\d)ELb(\d)E)?", body.split("\n", 1)[0])
            if m and m.group(2) == "0":
                self.sass["any{}_heap{}_fanout{}_half{}".format(
                    m.group(1), m.group(3), m.group(4) or 2,
                    m.group(5) or 0)] = [
                    re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0]
                    .strip() for line in body.splitlines()
                    if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
        return self

    def call(self, launch, bvh):
        """One launch in the main path's form."""
        rays, roots, splits, tl = cs.full_tiles(launch)
        npad = rays.shape[0]
        dev = rays.device
        outs = [torch.empty(npad, device=dev) for _ in range(4)]
        ptrs = [rays.data_ptr(), bvh.nodes.data_ptr(), bvh.tris.data_ptr(),
                roots.data_ptr(), splits.data_ptr(),
                *[o.data_ptr() for o in outs], None]
        ints = [npad, npad // tl, tl, bvh.num_clusters, bvh.cluster_size,
                int(launch["any_hit"])]
        stream = torch.cuda.current_stream().cuda_stream
        if self.binned and launch["roots"] is not None:
            err = self.lib.vsnray_traverse_binned(*ptrs, *ints, 2, 0, stream)
        else:
            err = self.lib.vsnray_traverse(
                *ptrs, *ints, 1, *([2, 0] if self.wide else []), stream)
        if err:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {err}")
        return outs


def same_outputs(a, b, any_hit):
    if any_hit:
        return torch.equal(a[1] >= 0, b[1] >= 0)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    versions = [Version(*a.split("=", 1)) for a in sys.argv[1:]]
    with ThreadPoolExecutor(len(versions)) as pool:
        versions = list(pool.map(Version.build, versions))
    first = versions[0]
    for v in versions:
        same = {k: v.sass.get(k) == s for k, s in first.sass.items()}
        print(f"{v.name}: SASS of {len(v.sass)} non-counting traverse.cu "
              f"forms; equal to {first.name}'s: {sum(same.values())}/"
              f"{len(same)}" + ("" if all(same.values()) else
                                f" (differ: {[k for k, s in same.items() if not s]})"))
        for line in cs.ptxas_lines(v.log):
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
        rec = cs.LaunchRecorder(trav.cluster_traverse)
        with cs.recorded(rec):
            render_pixels(params, cam, x, y, cs.WIDTH, cs.HEIGHT,
                          "pathtracing", cs.SPP, "jittered_blend", 1, nee=True)
        for key in BINNED:
            print(f"{key}: {len(rec.launches[key])} launches, live lanes "
                  f"{[int((ln['rays'][:, 6] >= 0).sum()) for ln in rec.launches[key]]}")

        first_ms, frame_ms = {}, {}
        for rnd in range(ROUNDS):
            for v in versions[rnd % len(versions):] + \
                    versions[:rnd % len(versions)]:
                for key, _, _ in cs.MODES:
                    times = [cs.cuda_ms(lambda: v.call(ln, bvh), 3)
                             for ln in rec.launches[key]]
                    first_ms.setdefault((key, v.name), []).append(times[0])
                    frame_ms.setdefault((key, v.name), []).append(sum(times))
        for key, _, row in cs.MODES:
            n = len(rec.launches[key])
            for label, table in (("first launch", first_ms),
                                 (f"sum of {n} launches", frame_ms)):
                print(f"mode {row} ({key}) ms, {label}, least/mean of "
                      f"{ROUNDS}: " + "  ".join(
                          f"{v.name}={min(table[(key, v.name)]):.4f}/"
                          f"{sum(table[(key, v.name)]) / ROUNDS:.4f}"
                          for v in versions))
        for v in versions[1:]:
            same = all(same_outputs(v.call(ln, bvh), first.call(ln, bvh),
                                    ln["any_hit"])
                       for key, _, _ in cs.MODES for ln in rec.launches[key])
            print(f"{v.name}: outputs equal to {first.name}'s on every "
                  f"launch: {same}")
    print(f"card: {cs.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
