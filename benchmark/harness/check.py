"""How ``correct`` is decided: the program's outputs from the window
against the plain reference (``reference/pathtrace.py``), number by
number, each under its limit in ``checks/<cell>.json`` (the readings
each limit was set from are in PERF.md).

What is kept from the window (``kept``):

- a frame mix: the colours of a sample of pixels, drawn from the seed, of
  the window's first and last frames, with their frame numbers;
- a training mix: the loss and both gradients of the window's first and
  last steps, with their frame numbers.

Numbers (each the worst over the kept frames or steps):

- ``pix_off``: the share of sampled pixels whose largest RGB gap to the
  reference exceeds the limits file's ``pixel_tol`` (or is not finite);
- ``mean_gap``: the mean absolute RGB gap (read for the record; no limit:
  the control's reading, ~3e4, would only allow a limit near 1);
- ``loss_gap``: |loss - reference| / |reference|;
- ``gv_gap``, ``gcd_gap``: the relative L2 distance of the vertex and the
  diffuse-colour gradients to the reference's.
"""

from __future__ import annotations

import math

import numpy as np


def reference_scene(config, traffic, seed, device, dtype):
    import torch

    from harness import spec
    from reference import pathtrace
    gen = spec.scene_module(config["scene"]["generator"])
    verts, faces, gids, cam = gen.build(config["scene"], seed)
    return pathtrace.make_scene(verts, faces, gids, config, cam, device,
                                dtype or torch.float32)


def reference_outputs(config, traffic, seed, kept, device, dtype=None):
    """The reference's values for everything in ``kept`` (computed in
    ``dtype``, float32 by default): a list in ``kept["items"]`` order."""
    import torch

    from harness import pixels
    from reference import pathtrace
    sc = reference_scene(config, traffic, seed, device, dtype)
    W, H = traffic["width"], traffic["height"]
    x, y = pixels.order(traffic["pixel_order"], W, H)
    out = []
    if kept["kind"] == "frame":
        idx = kept["lanes"]
        xs = torch.as_tensor(x[idx], device=device)
        ys = torch.as_tensor(y[idx], device=device)
        for frame, _ in kept["items"]:
            with torch.no_grad():
                c = pathtrace.render(sc, xs, ys, W, H, frame,
                                     traffic["bounces"])
            out.append(c.float().cpu().numpy())
        return out
    xp, yp = pixels.padded(x, y, traffic["tile"])
    xs = torch.as_tensor(xp, device=device)
    ys = torch.as_tensor(yp, device=device)
    for frame, *_ in kept["items"]:
        loss, gv, gc = pathtrace.loss_and_grads(
            sc, xs, ys, W, H, frame, traffic["bounces"], W * H)
        out.append((loss, gv.cpu().numpy(), gc.cpu().numpy()))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / nb if nb > 0 else math.inf


def numbers(kept, ref, pixel_tol: float) -> dict:
    """The compared numbers of ``kept`` against ``ref`` (see above)."""
    if kept["kind"] == "frame":
        offs, gaps = [], []
        for (_, got), want in zip(kept["items"], ref):
            gap = np.abs(np.asarray(got, np.float64)[:, :3]
                         - np.asarray(want, np.float64)[:, :3])
            bad = ~np.isfinite(gap).all(-1)
            offs.append(float(((gap.max(-1) > pixel_tol) | bad).mean()))
            gaps.append(float(np.where(np.isfinite(gap), gap, 1e9).mean()))
        return dict(pix_off=max(offs), mean_gap=max(gaps))
    loss, gv, gc = [], [], []
    for (_, l_, v_, c_), (rl, rv, rc) in zip(kept["items"], ref):
        loss.append(abs(l_ - rl) / abs(rl) if math.isfinite(l_)
                    else math.inf)
        gv.append(_rel(v_, rv))
        gc.append(_rel(c_, rc))
    return dict(loss_gap=max(loss), gv_gap=max(gv), gcd_gap=max(gc))


def control(config, traffic, seed, kept, device, pixel_tol: float,
            ref=None) -> dict:
    """The control's numbers: the reference computed in the precision
    below the configuration's (bfloat16 for its float32) put in the
    program's place, on the frames or steps of ``kept``, against the
    reference in float32 (``ref``, when already computed)."""
    import torch
    dtype = torch.bfloat16
    if ref is None:
        ref = reference_outputs(config, traffic, seed, kept, device)
    low = reference_outputs(config, traffic, seed, kept, device, dtype)
    if kept["kind"] == "frame":
        items = [(f, c) for (f, _), c in zip(kept["items"], low)]
    else:
        items = [(f, *o) for (f, *_), o in zip(kept["items"], low)]
    return numbers(dict(kept, items=items), ref, pixel_tol)


NO_READING = 1e300     # a number that is missing, infinite or NaN


def judge(nums: dict, limits: dict):
    """(correct, {name: {value, limit}}): every limited number present,
    finite and at or under its limit (one that is not is reported as
    NO_READING, so the result line stays plain JSON)."""
    checks = {}
    for k, lim in limits.items():
        v = nums.get(k, math.inf)
        checks[k] = dict(value=v if math.isfinite(v) else NO_READING,
                         limit=lim)
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
