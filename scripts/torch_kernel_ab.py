"""A/B of versions of the port's traversal kernel source on one GPU.

    python3 scripts/torch_kernel_ab.py NAME=PATH.cu [NAME=PATH.cu ...]

Builds each source with the port's nvcc flags, captures the first launch
of each main-path mode (1, 1b, 1c, 1d) from the 1080p frame of
chip_smoke.py, and times every version on those launches in turns (four
rounds, the order rotated each round), binary descent without the
half-cluster skip.  Prints per mode the least and the mean ms per launch
of each version, whether each version's outputs equal the first one's, and
whether the SASS (cuobjdump) of each binary-descent instantiation equals
the first version's.  A source whose entry point predates the fanout and
half_skip arguments is called without them.
"""

import ctypes
import re
import subprocess
import sys
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


def build(name, src):
    """(library, takes the 1f arguments, {instantiation: SASS lines})."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"{name}.so"
    out = subprocess.run([trav._nvcc(), *trav.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stderr}")
    wide = "int half_skip" in Path(src).read_text()
    lib = ctypes.CDLL(str(so))
    lib.vsnray_traverse.argtypes = ([ctypes.c_void_p] * 10
                                    + [ctypes.c_int] * (9 if wide else 7)
                                    + [ctypes.c_void_p])
    lib.vsnray_traverse.restype = ctypes.c_int
    cuobjdump = Path(trav._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    kernels = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"traverse_kernelILb(\d)ELb(\d)ELb(\d)E(?:Li(\d)ELb(\d)E)?",
                      body.split("\n", 1)[0])
        if m and m.group(4) in (None, "2") and m.group(5) in (None, "0"):
            kernels["any{}_count{}_heap{}".format(*m.groups()[:3])] = [
                re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip()
                for line in body.splitlines()
                if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
    return lib, wide, kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    variants = dict(a.split("=", 1) for a in sys.argv[1:])
    names = list(variants)
    built = {n: build(n, p) for n, p in variants.items()}
    first = names[0]
    for n in names:
        sizes = " ".join(f"{k}:{len(v)}" for k, v in sorted(built[n][2].items()))
        same = all(built[n][2].get(k) == v for k, v in built[first][2].items())
        print(f"{n}: SASS instructions {sizes}; equal to {first}'s: {same}")

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

        def call(n, launch):
            lib, wide, _ = built[n]
            rays, roots, splits, tl = cs.full_tiles(launch)
            npad = rays.shape[0]
            outs = [torch.empty(npad, device=dev) for _ in range(4)]
            args = [rays.data_ptr(), bvh.nodes.data_ptr(), bvh.tris.data_ptr(),
                    roots.data_ptr(), splits.data_ptr(),
                    *[o.data_ptr() for o in outs], None, npad, npad // tl, tl,
                    bvh.num_clusters, bvh.cluster_size,
                    int(launch["any_hit"]), 1] + ([2, 0] if wide else [])
            err = lib.vsnray_traverse(*args,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{n}: launch failed, cudaError {err}")
            return outs

        times = {}
        for rnd in range(ROUNDS):
            for n in names[rnd % len(names):] + names[:rnd % len(names)]:
                for key, _, _ in cs.MODES:
                    times.setdefault((key, n), []).append(
                        cs.cuda_ms(lambda: call(n, rec.first[key]), 5))
        for key, _, row in cs.MODES:
            print(f"mode {row} ({key}) ms per launch, least/mean of {ROUNDS}: "
                  + "  ".join(f"{n}={min(times[(key, n)]):.4f}/"
                              f"{sum(times[(key, n)]) / ROUNDS:.4f}"
                              for n in names))
        ref = {k: call(first, rec.first[k]) for k, _, _ in cs.MODES}
        for n in names[1:]:
            same = all(torch.equal(a, b) for k, _, _ in cs.MODES
                       for a, b in zip(call(n, rec.first[k]), ref[k]))
            print(f"{n}: outputs equal to {first}'s: {same}")
    print(f"card: {cs.nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
