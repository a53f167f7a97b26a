"""A/B of versions of the LBVH walk (traverse_lbvh.cu) and the volume
march's backward (volume_march_bwd.cu) on one GPU.

    python3 scripts/torch_kernel_ab_lbvh_volume.py [--lbvh-only]
        NAME=PACKAGE [NAME=...]

PACKAGE is a copy of the port's package: ``visionaray_torch`` itself, or
a parent's, unpacked with
``git archive HEAD visionaray_torch | tar -x -C build/parent`` into the
git-ignored ``build/`` (then ``build/parent/visionaray_torch``).  Each
version's two kernels are built from PACKAGE/ops/cuda with the port's
nvcc flags, all builds at once (the frames that capture the launches run
the port's own library), and launched through that version's own
``ops/traversal.py::launch`` and ``kernels/volume.py::march_backward``,
so a version whose entry points take other arguments is called as it
expects.  The first version is the reference of every comparison.

The script captures every LBVH launch of chip_smoke.py's phases 14a (the
simple frame on the default scene's LBVH), 14b (the 5-bounce NEE frame),
14d (multi_hit, k=16), 14e (the prim % 7 filtered frame), 15 (the simple
frames on the SAH and SBVH trees) and 16 (the sphere field's Whitted
frame), and builds phase 20's backward launches on volume_scene(256) and
multi_volume_scene(128, 3) (1080p primary rays, dL/dcolor of the volume
step's MSE): the texel and transfer form (<false>) and every gradient
(<true>; ``--lbvh-only`` leaves them out).  Every version is timed on
each launch in turns (ROUNDS rounds, the order rotated each round, CUDA
events, 3 launches after a warm one).  Prints:

- per group, the least and the mean over rounds of the first launch's ms
  and of the group's summed ms, per version;
- every LBVH launch of each version against the first's: t bit-equal
  (NaN as NaN), refs equal and the per-lane box and primitive test counts
  equal;
- each backward form of each version against the first's on the full
  launch, and against the plain version's autograd on chip_smoke.py's
  three COMPARE_LANES-lane subsets: relative L2 <= GRAD_BWD_REL and cosine
  >= GRAD_BWD_COS for every gradient;
- registers, stack and spills (ptxas) of each version's LBVH and
  backward forms, and the shared-memory atomics in each backward form's
  SASS by opcode (cuobjdump -sass);
- the card's name and power limit, and one JSON line of the numbers.
Exits non-zero when a comparison fails.
"""

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import types
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
import visionaray_torch.kernels.volume as tvol  # noqa: E402
import visionaray_torch.ops.traversal as tt  # noqa: E402
import visionaray_torch.ops.traverse as trav  # noqa: E402
from visionaray_torch.kernels.params import KernelParams  # noqa: E402
from visionaray_torch.ops import sah  # noqa: E402
from visionaray_torch.ops.trace import multi_hit  # noqa: E402
from visionaray_torch.scenes.sponza_like import sponza_like_scene  # noqa: E402
from visionaray_torch.scenes.volume_demo import (  # noqa: E402
    multi_volume_scene, volume_scene,
)
from visionaray_torch.sched.render import (  # noqa: E402
    _pixel_grid, render, render_pixels,
)

BUILD = Path(__file__).resolve().parents[1] / "build" / "kernel_ab_lv"
ROUNDS = 4
WANTED = {"<false> texels, transfer": ("texels", "transfer"),
          "<true> every gradient": tvol._GRADS}


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class Version:
    """One version: its library, built from its own sources, and its own
    launch wrappers (loaded from its package, bound to its library)."""

    def __init__(self, name, package):
        self.name = name
        self.package = Path(package)
        self.dir = BUILD / name

    def build(self):
        cuda = self.package / "ops" / "cuda"
        so = trav.build_library([cuda / "traverse_lbvh.cu",
                                 cuda / "volume_march_bwd.cu"], self.dir)
        self.log = (self.dir / "nvcc.log").read_text()
        bind = _module(self.package / "ops" / "traverse.py",
                       f"ab_traverse_{self.name}")
        self.lib = bind.bind_library(so)
        self.tt = _module(self.package / "ops" / "traversal.py",
                          f"ab_traversal_{self.name}")
        self.vol = _module(self.package / "kernels" / "volume.py",
                           f"ab_volume_{self.name}")
        # the backward's wrapper finds the library and its counts here
        self.vol.trav = types.SimpleNamespace(
            _library=lambda: self.lib, LAUNCHES=Counter(),
            ENTRY_LAUNCHES=Counter())
        cuobjdump = Path(trav._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                              capture_output=True, text=True,
                              check=True).stdout
        self.atomics = {}
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            head = body.split("\n", 1)[0]
            m = re.search(r"volume_bwd_kernelILb(\d)E", head)
            if m:
                ops = re.findall(r"\bATOMS\.[A-Z0-9.]+", body)
                self.atomics[f"volume_bwd pos={m.group(1)}"] = dict(
                    Counter(ops))
        return self

    def lbvh(self, ln, counters=None):
        stream = torch.cuda.current_stream().cuda_stream
        return self.tt.launch(self.lib, ln["o"], ln["d"], ln["max_t"],
                              ln["bvh"], ln["prim"], ln["tables"],
                              ln["mode"], ln["k"], counters, stream)

    def backward(self, case, wanted, o=None, d=None, dst=None, gcolor=None):
        return self.vol.march_backward(
            case["o"] if o is None else o, case["d"] if d is None else d,
            case["vols"], case["bg"], case["dst"] if dst is None else dst,
            case["gcolor"] if gcolor is None else gcolor, 1.0, wanted)


def capture_lbvh(dev):
    """(label, launches) of phases 14a, 14b, 14d, 14e, 15 and 16."""
    scene, cam = sponza_like_scene(target_tris=cs.TARGET_TRIS, device=dev)
    params = KernelParams.create(
        scene, num_bounces=cs.BOUNCES, epsilon=1e-3,
        bg_color=(0.2, 0.3, 0.5, 1.0), ambient_color=(1.0, 1.0, 1.0, 1.0))
    x, y = cs.swizzled_pixels(dev)
    px, py = _pixel_grid(cs.WIDTH, cs.HEIGHT, dev)
    ray = cam.primary_rays(px, py, cs.WIDTH, cs.HEIGHT)
    sph, sph_cam, _ = cs.sphere_scene(dev)
    runs = [
        ("14a simple frame", lambda: render(scene, cam, cs.WIDTH, cs.HEIGHT)),
        ("14b nee frame", lambda: render_pixels(
            params, cam, x, y, cs.WIDTH, cs.HEIGHT, "pathtracing", cs.SPP,
            "jittered_blend", 1, nee=True)),
        ("14d multi_hit k=16", lambda: multi_hit(ray, scene,
                                                 k=cs.MULTI_HIT_K)),
        ("14e filtered frame", lambda: render(
            scene, cam, cs.WIDTH, cs.HEIGHT, hit_filter=cs.reject_mod7)),
        ("15 sah simple frame", lambda: render(dataclasses.replace(
            scene, bvh=sah.build_sah(scene.mesh)), cam, cs.WIDTH,
            cs.HEIGHT)),
        ("15 sbvh simple frame", lambda: render(dataclasses.replace(
            scene, bvh=sah.build_sbvh(scene.mesh)), cam, cs.WIDTH,
            cs.HEIGHT)),
        ("16 sphere whitted frame", lambda: render(
            sph, sph_cam, cs.WIDTH, cs.HEIGHT, algo="whitted")),
    ]
    groups = []
    for label, run in runs:
        rec = cs.BvhRecorder(tt.bvh_traverse)
        with cs.bvh_recorded(rec):
            run()
        torch.cuda.synchronize()
        for key, lns in rec.launches.items():
            groups.append((f"{label} {key}", lns))
    return groups


def volume_cases(dev):
    """Phase 20's backward launches: both scenes at 1080p, dL/dcolor of
    the MSE against the frame with the transfer scaled by 0.8."""
    cases = []
    for label, (scene, cam) in (
            (f"volume_scene({cs.VOLUME_RES})",
             volume_scene(cs.VOLUME_RES, device=dev)),
            (f"multi_volume_scene({cs.MULTI_RES}, {cs.MULTI_N})",
             multi_volume_scene(cs.MULTI_RES, cs.MULTI_N, device=dev))):
        vols = scene.volumes
        px, py = _pixel_grid(cs.WIDTH, cs.HEIGHT, dev)
        ray = cam.primary_rays(px, py, cs.WIDTH, cs.HEIGHT)
        o, d = ray.ori.contiguous(), ray.dir.contiguous()
        bg = torch.tensor(cs.RENDER_BG, device=dev)
        target = render(dataclasses.replace(scene, volumes=dataclasses.replace(
            vols, transfer=vols.transfer * cs.TARGET_TRANSFER_SCALE)), cam,
            cs.WIDTH, cs.HEIGHT, algo="volume").color.reshape(-1, 4)
        color, _, _, dst = tvol._launch(o, d, vols, bg, 1.0, save_dst=True)
        gcolor = (2.0 / color.numel()) * (color - target)
        n = o.shape[0]
        lanes = torch.cat([torch.arange(s0, s0 + cs.COMPARE_LANES, device=dev)
                           for s0 in (0, n // 2 - cs.COMPARE_LANES // 2,
                                      n - cs.COMPARE_LANES)])
        w = torch.as_tensor(np.random.default_rng(20).uniform(
            -1.0, 1.0, (lanes.numel(), 4)).astype(np.float32), device=dev)
        cases.append(dict(label=label, vols=vols, o=o, d=d, bg=bg, dst=dst,
                          gcolor=gcolor, lanes=lanes, w=w))
    return cases


def plain_grads(case, wanted):
    """The plain version's autograd of sum(color * w) on the case's lane
    subsets."""
    names = tvol._GRADS
    vols, lanes = case["vols"], case["lanes"]
    src = dict(o=case["o"][lanes], d=case["d"][lanes], lo=vols.lo,
               hi=vols.hi, texels=vols.texels, transfer=vols.transfer)
    leaves = {k: src[k].detach().clone().requires_grad_(k in wanted)
              for k in names}
    with torch.enable_grad():
        color, _, _ = tvol.march_plain(leaves["o"], leaves["d"], tvol.Volumes(
            lo=leaves["lo"], hi=leaves["hi"], texels=leaves["texels"],
            transfer=leaves["transfer"]), case["bg"])
        (color * case["w"]).sum().backward()
    return {k: leaves[k].grad for k in wanted}


def kernel_grads_subset(v, case, wanted):
    lanes = case["lanes"]
    o, d = case["o"][lanes].contiguous(), case["d"][lanes].contiguous()
    _, _, _, dst = tvol._launch(o, d, case["vols"], case["bg"], 1.0,
                                save_dst=True)
    return v.backward(case, wanted, o=o, d=d, dst=dst, gcolor=case["w"])


def stats(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    rel = float((a - b).norm() / b.norm().clamp_min(1e-300))
    cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
    return rel, cos


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab_lbvh_volume: needs a CUDA GPU",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    lbvh_only = "--lbvh-only" in args
    versions = [Version(*a.split("=", 1)) for a in args if "=" in a]
    with ThreadPoolExecutor(len(versions) + 1) as pool:
        own = pool.submit(trav._library)
        versions = list(pool.map(Version.build, versions))
        own.result()
    first = versions[0]
    report = {"card": cs.nvidia_smi_line(), "ptxas": {}, "sass_atomics": {}}
    for v in versions:
        lines = [ln for ln in cs.ptxas_lines(v.log)
                 if ln.startswith(("lbvh", "volume_bwd"))]
        report["ptxas"][v.name] = lines
        report["sass_atomics"][v.name] = v.atomics
        for ln in lines:
            print(f"  {v.name} ptxas {ln}")
        for form, ops in v.atomics.items():
            print(f"  {v.name} SASS atomics of {form}: {ops}")
    dev = torch.device("cuda")
    ok = True
    with torch.no_grad():
        groups = capture_lbvh(dev)
        for label, lns in groups:
            print(f"{label}: {len(lns)} launches, lanes "
                  f"{[ln['o'].shape[0] for ln in lns]}", flush=True)
        cases = [] if lbvh_only else volume_cases(dev)

        # outputs and per-lane counts of every LBVH launch vs the first
        for v in versions[1:]:
            for label, lns in groups:
                same_t = same_ref = same_cnt = True
                for ln in lns:
                    n = ln["o"].shape[0]
                    ca = torch.zeros((n, 2), dtype=torch.int32, device=dev)
                    cb = torch.zeros((n, 2), dtype=torch.int32, device=dev)
                    ta, ra = v.lbvh(ln, ca)
                    tb, rb = first.lbvh(ln, cb)
                    same_t &= torch.equal(torch.nan_to_num(ta, nan=-7.0),
                                          torch.nan_to_num(tb, nan=-7.0))
                    same_ref &= torch.equal(ra, rb)
                    same_cnt &= torch.equal(ca, cb)
                good = same_t and same_ref and same_cnt
                ok &= good
                print(f"{v.name} vs {first.name}, {label}: t bit-equal "
                      f"{same_t}, refs equal {same_ref}, box and primitive "
                      f"tests per lane equal {same_cnt} "
                      f"{'OK' if good else 'FAIL'}", flush=True)

        # backward gradients: each version vs the first on the full
        # launch, and vs the plain version on the lane subsets
        for case in cases:
            for form, wanted in WANTED.items():
                ref = first.backward(case, wanted)
                plain = plain_grads(case, wanted)
                for v in versions:
                    got = v.backward(case, wanted)
                    sub = kernel_grads_subset(v, case, wanted)
                    torch.cuda.synchronize()
                    full = {k: stats(got[k], ref[k]) for k in wanted}
                    vs_plain = {k: stats(sub[k], plain[k]) for k in wanted}
                    good = all(r <= cs.GRAD_BWD_REL and c >= cs.GRAD_BWD_COS
                               for r, c in [*full.values(),
                                            *vs_plain.values()])
                    ok &= good
                    print(f"{v.name} {case['label']} {form}: vs "
                          f"{first.name} (full launch) "
                          + " ".join(f"{k}={r:.3e}/{c:.8f}"
                                     for k, (r, c) in full.items())
                          + f" | vs plain ({case['lanes'].numel()} lanes) "
                          + " ".join(f"{k}={r:.3e}/{c:.8f}"
                                     for k, (r, c) in vs_plain.items())
                          + f" {'OK' if good else 'FAIL'}", flush=True)

        # times, in turns
        first_ms, sum_ms = {}, {}
        for rnd in range(ROUNDS):
            order = versions[rnd % len(versions):] + \
                versions[:rnd % len(versions)]
            for v in order:
                for label, lns in groups:
                    times = [cs.cuda_ms(lambda: v.lbvh(ln), 3) for ln in lns]
                    first_ms.setdefault((label, v.name), []).append(times[0])
                    sum_ms.setdefault((label, v.name), []).append(sum(times))
                for case in cases:
                    for form, wanted in WANTED.items():
                        label = f"backward {case['label']} {form}"
                        t = cs.cuda_ms(lambda: v.backward(case, wanted), 3)
                        first_ms.setdefault((label, v.name), []).append(t)
                        sum_ms.setdefault((label, v.name), []).append(t)
    labels = [g[0] for g in groups] + [
        f"backward {c['label']} {f}" for c in cases for f in WANTED]
    report["times"] = {}
    for label in labels:
        row = {}
        for v in versions:
            f, s = first_ms[(label, v.name)], sum_ms[(label, v.name)]
            row[v.name] = dict(first_min=min(f), first_mean=sum(f) / ROUNDS,
                               sum_min=min(s), sum_mean=sum(s) / ROUNDS)
        report["times"][label] = row
        print(f"{label} ms, first launch / sum, least (mean) of {ROUNDS}: "
              + "  ".join(f"{n}={r['first_min']:.4f} ({r['first_mean']:.4f})"
                          f" / {r['sum_min']:.4f} ({r['sum_mean']:.4f})"
                          for n, r in row.items()), flush=True)
    print(f"card: {report['card']}")
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
