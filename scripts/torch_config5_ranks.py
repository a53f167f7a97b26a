#!/usr/bin/env python3
"""Config #5 on several cards: chip_smoke.py's phase 23 (sponza_x16 at
3840x2160, geometry-sharded over the ranks on the lbvh and cluster
backends, against the unsharded frame of this process) with ``--ranks``
ranks: one a card over NCCL when there are enough cards, else sharing
them over gloo (multihost.local_backend).

    python3 scripts/torch_config5_ranks.py [--ranks 4]

chip_smoke.py runs the same phase with two gloo ranks sharing one card;
on a host with four cards this script runs four NCCL ranks, where no
tensor is staged through the host.  It prints the card's name and power
limit, each rank's lines and a JSON line of the ranks' numbers, and
exits non-zero when the phase fails.
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_config5_ranks: no GPU", file=sys.stderr)
        return 2
    print(c.nvidia_smi_line(), "cards:", torch.cuda.device_count(),
          flush=True)
    c.trav._library()   # built once here; the ranks load it
    entries = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        dev = torch.device("cuda")
        ok, res = c.config5_phase(dev, tmp, entries, world=args.ranks)
        print(f"config #5 on {args.ranks} ranks over "
              f"{c.multihost.local_backend(args.ranks, dev)}: "
              f"{'OK' if ok else 'FAIL'} in {time.time() - t0:.1f} s",
              flush=True)
    print(json.dumps({b: [{k: r[k] for k in ("rank", "frame", "grad_step",
                                             "soup_bytes", "profile")
                           if k in r} for r in res[b]]
                      for b in c.CONFIG5_BACKENDS}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
