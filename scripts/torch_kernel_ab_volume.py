"""A/B of versions of the volume march (volume_march.cu) on one GPU, with
its backward (volume_march_bwd.cu) timed alongside as a guard.

    python3 scripts/torch_kernel_ab_volume.py NAME=PACKAGE[@BRICK][@FORM]
        [NAME=...]

PACKAGE is a copy of the port's package: ``visionaray_torch`` itself, or
a parent's, unpacked with
``git archive HEAD visionaray_torch | tar -x -C build/parent`` into the
git-ignored ``build/`` (then ``build/parent/visionaray_torch``).  Each
package's two volume kernels are built from PACKAGE/ops/cuda with the
port's nvcc flags, all builds at once, and launched through that
package's own ``kernels/volume.py`` (``_launch``, ``march_backward``), so
a version whose entry points take other arguments is called as it
expects.  BRICK (a power of 2) sets that module's BRICK, FORM
(``shared`` or ``global``) the transfer form it launches; a version that
has no brick table takes neither.  The first version is the reference of
every comparison.

On volume_scene(256) and multi_volume_scene(128, 3), chip_smoke.py's
phase 19 and 20 launches (1080p primary rays; dL/dcolor of the volume
step's MSE), every version is timed in turns (ROUNDS rounds, the order
rotated each round, CUDA events, 3 launches after a warm one): the
forward, and the backward's two forms (<false>: texels and transfer;
<true>: every gradient).  Prints:

- per launch, the least and the mean over rounds of each version's ms;
- each version's forward against the first's (colour, hit, depth and
  the saved composite bit for bit, NaN as NaN) and against
  ``march_plain`` on chip_smoke.py's three COMPARE_LANES-lane subsets
  (max abs colour, hit and depth mismatches); its counting form's steps
  against the first's and, where it has them, its empty steps and its
  warp-iterations whose every lane skipped;
- each version's backward outputs against the first's: the rays'
  gradients bit for bit (each thread sums its own), the others' relative
  L2 beside that of two launches of the first version (its atomic adds
  reorder the sums from run to run);
- ptxas' registers, stack and spills of every volume form, the step
  loop's SASS instructions of each forward form (chip_smoke.step_loop)
  and whether each backward form's SASS equals the first version's;
- the time to build a version's tables (``build_pack``, where it has
  one), the card's name and power limit, and one JSON line of the
  numbers.  The forward forms' SASS, step loops marked, goes to
  chiprun_out/ab_volume_sass.txt.
Exits non-zero when a comparison fails.
"""

import dataclasses
import importlib.util
import inspect
import json
import sys
import types
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
import visionaray_torch.kernels.volume as tvol  # noqa: E402
import visionaray_torch.ops.traverse as trav  # noqa: E402
from visionaray_torch.scenes.volume_demo import (  # noqa: E402
    multi_volume_scene, volume_scene,
)
from visionaray_torch.sched.render import _pixel_grid, render  # noqa: E402

BUILD = ROOT / "build" / "kernel_ab_vol"
OUT = ROOT / "chiprun_out"
ROUNDS = 4
WANTED = {"<false> texels, transfer": ("texels", "transfer"),
          "<true> every gradient": tvol._GRADS}


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod   # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class Build:
    """One package's library and its kernels' SASS."""

    def __init__(self, key, package):
        self.package = Path(package)
        self.dir = BUILD / key

    def run(self):
        cuda = self.package / "ops" / "cuda"
        self.so = trav.build_library([cuda / "volume_march.cu",
                                      cuda / "volume_march_bwd.cu"],
                                     self.dir)
        self.log = (self.dir / "nvcc.log").read_text()
        self.sass = cs.kernel_sass(self.so)
        return self


class Version:
    """One version: a package's library, its own kernels/volume.py bound
    to it, and the brick size and transfer form it launches."""

    def __init__(self, spec, builds):
        self.name, rest = spec.split("=", 1)
        package, *opts = rest.split("@")
        self.build = builds.setdefault(package, Build(
            f"b{len(builds)}", package))
        self.brick = next((int(o) for o in opts if o.isdigit()), None)
        self.form = next((o for o in opts if not o.isdigit()), None)

    def bind(self):
        b = self.build
        bind = _module(b.package / "ops" / "traverse.py",
                       f"ab_traverse_{self.name}")
        lib = bind.bind_library(b.so)
        self.vol = _module(b.package / "kernels" / "volume.py",
                           f"ab_volume_{self.name}")
        self.vol.trav = types.SimpleNamespace(
            _library=lambda: lib, LAUNCHES=Counter(),
            ENTRY_LAUNCHES=Counter(), VARIANT_LAUNCHES={})
        self.params = inspect.signature(self.vol._launch).parameters
        self.skips = "empty" in self.params
        if self.brick is not None:
            self.vol.BRICK = self.brick
        return self

    def vols(self, case):
        # a table of its own (the pack is kept per texels tensor)
        key = f"vols_{self.name}"
        if key not in case:
            v = case["vols"]
            case[key] = dataclasses.replace(
                v, texels=v.texels.clone(), transfer=v.transfer.clone()) \
                if self.skips else v
        return case[key]

    def forward(self, case, o=None, d=None, **kw):
        if self.form is not None:
            kw["form"] = self.form
        return self.vol._launch(case["o"] if o is None else o,
                                case["d"] if d is None else d,
                                self.vols(case), case["bg"], 1.0, **kw)

    def backward(self, case, wanted):
        return self.vol.march_backward(
            case["o"], case["d"], case["vols"], case["bg"], case["dst"],
            case["gcolor"], 1.0, wanted)


def cases(dev):
    """Phase 19 and 20's launches: both scenes at 1080p, dL/dcolor of the
    MSE against the frame with the transfer scaled by 0.8."""
    out = []
    for label, (scene, cam) in (
            ("volume", volume_scene(cs.VOLUME_RES, device=dev)),
            ("multi volume", multi_volume_scene(cs.MULTI_RES, cs.MULTI_N,
                                                device=dev))):
        vols = scene.volumes
        px, py = _pixel_grid(cs.WIDTH, cs.HEIGHT, dev)
        ray = cam.primary_rays(px, py, cs.WIDTH, cs.HEIGHT)
        o, d = ray.ori.contiguous(), ray.dir.contiguous()
        bg = torch.tensor(cs.RENDER_BG, device=dev)
        target = render(dataclasses.replace(scene, volumes=dataclasses.replace(
            vols, transfer=vols.transfer * cs.TARGET_TRANSFER_SCALE)), cam,
            cs.WIDTH, cs.HEIGHT, algo="volume").color.reshape(-1, 4)
        out.append(dict(label=label, vols=vols, o=o, d=d, bg=bg,
                        target=target))
    return out


def nan_equal(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def rel(a, b):
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_ab_volume: needs a CUDA GPU", file=sys.stderr)
        return 2
    builds = {}
    versions = [Version(a, builds) for a in sys.argv[1:] if "=" in a]
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        own = pool.submit(trav._library)
        list(pool.map(Build.run, builds.values()))
        own.result()
    versions = [v.bind() for v in versions]
    first = versions[0]
    ok = True
    report = {"card": cs.nvidia_smi_line(), "ptxas": {}, "sass": {},
              "versions": {v.name: dict(package=str(v.build.package),
                                        brick=v.brick, form=v.form)
                           for v in versions}}
    sass_dump, dumped = [], set()
    ref_sass = first.build.sass
    for v in versions:
        lines = [ln for ln in cs.ptxas_lines(v.build.log)
                 if ln.startswith("volume")]
        report["ptxas"][v.name] = lines
        loops = {}
        for form, ins in v.build.sass.items():
            if form.startswith("volume count="):
                loops[form] = cs.step_loop(ins)
                if (v.build, form) not in dumped and "count=0" in form:
                    # the whole form, its step loop marked
                    dumped.add((v.build, form))
                    lp = loops[form] or {"head": -1, "loop": 0}
                    end = lp["head"] + 16 * (lp["loop"] - 1)
                    sass_dump.append(f"== {v.name} {form}\n" + "\n".join(
                        f"{'>' if lp['head'] <= a <= end else ' '} "
                        f"/*{a:04x}*/ {i}" for a, i in ins))
            elif form.startswith("volume_bwd"):
                loops[form] = dict(instructions=len(ins),
                                   same_as_first=ins == ref_sass.get(form))
        report["sass"][v.name] = loops
        for ln in lines:
            print(f"  {v.name} ptxas {ln}")
        for form, info in loops.items():
            print(f"  {v.name} SASS {form}: {info}")
    OUT.mkdir(exist_ok=True)
    (OUT / "ab_volume_sass.txt").write_text("\n\n".join(sass_dump))
    dev = torch.device("cuda")
    times = {}
    with torch.no_grad():
        launches = cases(dev)
        for case in launches:
            label = case["label"]
            n = case["o"].shape[0]
            ref = first.forward(case, save_dst=True)
            case["dst"] = ref[3]
            case["gcolor"] = (2.0 / ref[0].numel()) * (ref[0] - case["target"])
            steps_ref = None
            for v in versions:
                steps = torch.zeros(n, dtype=torch.int32, device=dev)
                kw = {}
                if v.skips:
                    kw = dict(empty=torch.zeros(n, dtype=torch.int32,
                                                device=dev),
                              warps=torch.zeros(2, dtype=torch.int64,
                                                device=dev))
                got = v.forward(case, save_dst=True, steps=steps, **kw)
                plain_mm, max_abs = 0, 0.0
                for s0 in (0, n // 2 - cs.COMPARE_LANES // 2,
                           n - cs.COMPARE_LANES):
                    sl = slice(s0, s0 + cs.COMPARE_LANES)
                    pc, ph, pd = tvol.march_plain(case["o"][sl],
                                                  case["d"][sl],
                                                  case["vols"], case["bg"])
                    plain_mm += int((got[1][sl] != ph).sum()
                                    + (got[2][sl] != pd).sum())
                    max_abs = max(max_abs,
                                  float((got[0][sl] - pc).abs().max()))
                torch.cuda.synchronize()
                same = all(nan_equal(a, b) for a, b in zip(got, ref))
                total = int(steps.sum(dtype=torch.int64))
                steps_ref = total if steps_ref is None else steps_ref
                good = (same and plain_mm == 0 and max_abs == 0.0
                        and total == steps_ref)
                ok &= good
                rec = dict(bit_equal_first=same, plain_mismatch=plain_mm,
                           plain_max_abs=max_abs, steps=total)
                if v.skips:
                    e = int(kw["empty"].sum(dtype=torch.int64))
                    wi, we = (int(x) for x in kw["warps"])
                    rec.update(empty_steps=e, empty_share=e / total,
                               warp_iterations=wi, warp_all_empty=we,
                               warp_all_empty_share=we / max(wi, 1))
                    rec["volume_pack_ms"] = min(cs.cuda_ms(
                        lambda: v.vol.build_pack(
                            case["vols"].texels, case["vols"].transfer,
                            v.vol.BRICK), 1) for _ in range(3))
                report.setdefault("forward", {}).setdefault(
                    label, {})[v.name] = rec
                print(f"{v.name} {label} forward: {rec} "
                      f"{'OK' if good else 'FAIL'}", flush=True)
            # backward outputs vs the first version's
            for form, wanted in WANTED.items():
                a = first.backward(case, wanted)
                b = first.backward(case, wanted)
                torch.cuda.synchronize()
                noise = {k: rel(b[k], a[k]) for k in wanted}
                for v in versions[1:]:
                    g = v.backward(case, wanted)
                    torch.cuda.synchronize()
                    diff = {k: rel(g[k], a[k]) for k in wanted}
                    rays = all(torch.equal(g[k], a[k]) for k in ("o", "d")
                               if k in wanted)
                    good = rays and all(r <= cs.GRAD_BWD_REL
                                        for r in diff.values())
                    ok &= good
                    report.setdefault("backward", {}).setdefault(
                        f"{label} {form}", {})[v.name] = dict(
                            rays_bit_equal=rays, rel_l2=diff,
                            first_vs_itself=noise)
                    print(f"{v.name} {label} backward {form}: rays bit-equal "
                          f"{rays} rel L2 vs {first.name} "
                          + " ".join(f"{k}={r:.3e}" for k, r in diff.items())
                          + f" ({first.name} vs itself "
                          + " ".join(f"{k}={r:.3e}" for k, r in noise.items())
                          + f") {'OK' if good else 'FAIL'}", flush=True)

        for rnd in range(ROUNDS):
            k = rnd % len(versions)
            for v in versions[k:] + versions[:k]:
                for case in launches:
                    label = case["label"]
                    t = cs.cuda_ms(lambda: v.forward(case), 3)
                    times.setdefault(f"forward {label}", {}).setdefault(
                        v.name, []).append(t)
                    for form, wanted in WANTED.items():
                        t = cs.cuda_ms(lambda: v.backward(case, wanted), 3)
                        times.setdefault(f"backward {label} {form}",
                                         {}).setdefault(v.name,
                                                        []).append(t)
    report["times"] = {}
    for label, row in times.items():
        report["times"][label] = {
            n: dict(min=min(t), mean=sum(t) / len(t)) for n, t in row.items()}
        print(f"{label} ms, least (mean) of {ROUNDS}: " + "  ".join(
            f"{n}={min(t):.4f} ({sum(t) / len(t):.4f})"
            for n, t in row.items()), flush=True)
    print(f"card: {report['card']}")
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
