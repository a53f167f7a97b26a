"""Faults planted in the program underneath a run, to show that the
check catches them (the benchmark's tests, and ``readings.py --fault``
for the readings on the chip).  Each wraps one of the program's
functions; ``plant(name, kind)`` installs it and returns an undo.

- ``stale``: the step or frame returns its first answer forever, a step
  that leaves its state unchanged;
- ``half``: half of the batch left out: the training loss is the mean
  over every other pixel, a frame leaves every other pixel black;
- ``altered``: an answer altered where it is made: the walk reports a
  miss on every eighth lane;
- ``no_exchange``: the ring's hop between ranks left out, each rank
  keeping its own rays.
"""

from __future__ import annotations

FAULTS = ("stale", "half", "altered", "no_exchange")


def _stale(orig):
    first = []

    def f(*a, **k):
        if not first:
            first.append(orig(*a, **k))
        return first[0]
    return f


def _half_train(orig):
    def f(verts, cd, frame, params, cam, x, y, *a, **k):
        return orig(verts, cd, frame, params, cam, x[::2], y[::2], *a, **k)
    return f


def _half_frame(orig):
    import torch

    def f(params, cam, x, y, *a, **k):
        color, depth = orig(params, cam, x[::2], y[::2], *a, **k)
        full = torch.zeros((x.shape[0], 4), dtype=color.dtype,
                           device=color.device)
        full[::2] = color
        return full, torch.zeros(x.shape, dtype=depth.dtype,
                                 device=depth.device)
    return f


def _altered(orig):
    def f(o, d, max_t, bvh, prim, tables, mode, *a, **k):
        t, ref = orig(o, d, max_t, bvh, prim, tables, mode, *a, **k)
        ref = ref.clone()
        ref[::8] = -1
        return t, ref
    return f


def plant(name: str, kind: str):
    """Install fault ``name`` for a ``kind`` ("train" or "frame") mix;
    returns a function that takes it out again."""
    from visionaray_torch.ops import traversal
    from visionaray_torch.parallel import ring
    from visionaray_torch.sched import render, step
    if name == "altered":
        mod, attr, wrap = traversal, "bvh_traverse", _altered
    elif name == "no_exchange":
        mod, attr, wrap = ring, "hop", lambda orig: (lambda p, mesh: p)
    elif kind == "train":
        mod, attr = step, "loss_and_grads"
        wrap = _stale if name == "stale" else _half_train
    else:
        mod, attr = render, "render_pixels"
        wrap = _stale if name == "stale" else _half_frame
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    return lambda: setattr(mod, attr, orig)
