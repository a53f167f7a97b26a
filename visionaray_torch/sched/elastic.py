"""Elastic tile execution: failure detection, re-dispatch, resume (port of
sched/elastic.py).

The reference has no fault handling beyond a GPU-OOM fallback
(src/viewer/viewer.cpp:854-867).  Rendering is stateless per batch of
pixels, so recovery is re-dispatching the failed batch; long jobs
checkpoint finished batches and resume without re-rendering them.

A host-side loop over ``render_pixels``:
- splits the frame into fixed-size pixel batches;
- treats any exception from a batch's device work as a failure (the
  last one is kept in ``report.last_error``), and re-runs that batch up
  to ``retries`` more times (PyTorch compiles no per-call executable, so
  a retry is the same call again);
- counts a batch that fails every attempt in ``report.failed`` and
  leaves its pixels 0: the caller decides (the CLI prints it);
- persists finished batches to ``checkpoint_path`` (npz, the JAX
  package's layout) after every ``checkpoint_every`` batches: a restarted
  job resumes from there (preemption loses at most one window);
- ``fault_hook(batch_index, attempt)`` lets tests inject failures.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ElasticReport:
    """What happened while rendering one frame."""

    batches: int = 0
    completed: int = 0
    resumed: int = 0       # skipped: restored from checkpoint
    errors: int = 0        # exceptions observed
    retried: int = 0       # batches that succeeded only after re-dispatch
    failed: int = 0        # batches abandoned after all retries
    last_error: str = ""   # the last exception observed, as repr()

    @property
    def ok(self) -> bool:
        return self.failed == 0


def _grid(width, height):
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    return xx.reshape(-1).astype(np.int32), yy.reshape(-1).astype(np.int32)


def render_frame_elastic(params, cam, width: int, height: int,
                         algo: str = "pathtracing", spp: int = 1,
                         pixel_sampler: str = "jittered_blend",
                         frame_num: int = 1, nee: bool = False,
                         batch: int = 1 << 16, retries: int = 2,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 4,
                         fault_hook: Optional[Callable[[int, int], None]]
                         = None):
    """Render one frame on the scene's device with per-batch re-dispatch
    and optional resume.

    Returns (color (H, W, 4) numpy, ElasticReport).  Deterministic: the
    counter-based sampler keys on absolute pixel ids and each batch is the
    same call every time, so retried and resumed batches give
    bit-identical pixels.
    """
    from visionaray_torch.sched.render import render_pixels

    dev = params.scene.device
    x, y = _grid(width, height)
    n = x.shape[0]
    nb = -(-n // batch)
    npad = nb * batch
    xp = torch.as_tensor(np.pad(x, (0, npad - n)), device=dev)
    yp = torch.as_tensor(np.pad(y, (0, npad - n)), device=dev)
    out = np.zeros((npad, 4), np.float32)
    done = np.zeros((nb,), bool)
    report = ElasticReport(batches=nb)

    # resume: restore completed batches from a previous run
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if (int(ck["width"]) == width and int(ck["height"]) == height
                and int(ck["batch"]) == batch
                and int(ck["frame_num"]) == int(frame_num)):
            done = ck["done"].copy()
            out = ck["color"].copy()
            report.resumed = int(done.sum())

    def save_ck():
        if not checkpoint_path:
            return
        np.savez(checkpoint_path, width=width, height=height, batch=batch,
                 frame_num=int(frame_num), done=done, color=out)

    since_ck = 0
    for b in range(nb):
        if done[b]:
            continue
        tx = xp[b * batch:(b + 1) * batch]
        ty = yp[b * batch:(b + 1) * batch]
        ok = False
        for attempt in range(retries + 1):
            try:
                if fault_hook is not None:
                    fault_hook(b, attempt)
                color = render_pixels(params, cam, tx, ty, width, height,
                                      algo, spp, pixel_sampler, frame_num,
                                      nee=nee)[0]
                out[b * batch:(b + 1) * batch] = color.cpu().numpy()
                ok = True
                break
            except KeyboardInterrupt:
                save_ck()
                raise
            except Exception as e:   # any failure of the batch's work
                report.errors += 1
                report.last_error = repr(e)
        if ok:
            done[b] = True
            report.completed += 1
            if attempt > 0:
                report.retried += 1
            since_ck += 1
            if since_ck >= checkpoint_every:
                save_ck()
                since_ck = 0
        else:
            report.failed += 1
    save_ck()
    img = out[:n].reshape(height, width, 4)
    return img, report
