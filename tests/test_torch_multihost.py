"""The port's parallel/multihost.py against the JAX package's, and the
gloo rank harness the port's parallel tests share.

JAX runs its parallel code in this process over the virtual CPU devices
of tests/conftest.py; the port runs it in gloo processes, one a rank,
spawned by the port's ``multihost.spawn_local`` (as
tests/test_multiprocess_distributed.py spawns its workers).
``run_ranks`` writes the inputs (numpy arrays made from a seed, ``a/b``
keys for nested dicts) to an npz file, starts ``world`` workers that
each initialize the group through ``multihost.initialize`` and run a
body of code with the dict ``INP`` and fill the dict ``OUT``, waits for
all of them and returns each rank's ``OUT``.  A worker that fails fails
the test with its output.

The index functions (``padded_global_size``, ``local_slice``) must equal
JAX's for several (n, world size, rank): JAX's read the device and
process counts, which are patched here to the port's world size (one
rank per device).
"""

import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from visionaray_tpu.parallel import multihost as jmh

from visionaray_torch.parallel import multihost as tmh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PREAMBLE = """\
import os
import sys
import numpy as np
import torch
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
from visionaray_torch.parallel.multihost import initialize
assert initialize(device="cpu") == (WORLD > 1)


def _unflat(flat):
    out = {}
    for key, val in flat.items():
        node = out
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = val
    return out


with np.load(sys.argv[1], allow_pickle=False) as f:
    INP = _unflat({k: f[k] for k in f.files})
OUT = {}
"""

_EPILOGUE = """
np.savez(f"{sys.argv[2]}_{RANK}.npz",
         **{k: np.asarray(v) for k, v in OUT.items()})
from visionaray_torch.parallel.multihost import shutdown
shutdown()
"""


def flatten(d, prefix=""):
    """A nested dict of arrays as one level of ``a/b`` keys."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def run_ranks(tmp_path, world: int, body: str, inputs: dict,
              timeout: float = 240.0):
    """Run ``body`` on ``world`` gloo ranks (``multihost.spawn_local``);
    returns their OUT dicts."""
    tag = f"w{world}_{abs(hash(body)) % 10**8}"
    script = tmp_path / f"worker_{tag}.py"
    script.write_text(_PREAMBLE + textwrap.dedent(body) + _EPILOGUE)
    inp = tmp_path / f"in_{tag}.npz"
    np.savez(inp, **flatten(inputs))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    prefix = tmp_path / f"out_{tag}"
    outs = [tmp_path / f"out_{tag}_{r}.npz" for r in range(world)]
    logs = [tmp_path / f"log_{tag}_{r}.txt" for r in range(world)]
    files = [open(path, "w") for path in logs]
    try:
        codes = tmh.spawn_local(world, [str(script), str(inp), str(prefix)],
                                timeout=timeout, env=env, outputs=files)
    finally:
        for f in files:
            f.close()
    for r, code in enumerate(codes):
        assert code == 0, \
            f"rank {r} of {world} failed ({code}):\n{logs[r].read_text()}"
    res = []
    for path in outs:
        with np.load(path) as f:
            res.append({k: f[k] for k in f.files})
    return res


# ---------------------------------------------------------------------------
# multihost


CASES = [(n, ws) for n in (1, 7, 64, 100, 1000, 2_073_600)
         for ws in (1, 2, 3, 4, 8)]


@pytest.mark.parametrize("n,ws", CASES)
def test_index_functions_equal_jax(n, ws, monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: ws)
    monkeypatch.setattr(jax, "process_count", lambda: ws)
    assert tmh.padded_global_size(n, ws) == jmh.padded_global_size(n)
    for rank in range(ws):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        assert tmh.local_slice(n, ws, rank) == jmh.local_slice(n)


def test_single_process_defaults(monkeypatch):
    """No group: one rank, the local slice is everything (JAX's single
    process, with one device); initialize with nothing set is a no-op."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert tmh.padded_global_size(100) == 100
    assert tmh.local_slice(100) == slice(0, 100)
    mesh = tmh.global_mesh()
    assert mesh.size == 1 and mesh.rank == 0
    x = torch.arange(64, dtype=torch.float32)
    assert torch.equal(tmh.make_global_pixel_array(x, mesh), x)


_BODY_INIT = """
import torch.distributed as dist
from visionaray_torch.parallel import multihost
from visionaray_torch.parallel.comm import all_reduce_
# idempotent: a second call keeps the group
assert multihost.initialize("localhost:1", 99, 42, device="cpu") is True
assert dist.get_world_size() == WORLD and dist.get_rank() == RANK
mesh = multihost.global_mesh()
assert mesh.size == WORLD and mesh.rank == RANK
n_global = multihost.padded_global_size(10)
assert n_global % WORLD == 0
sl = multihost.local_slice(10)
local = torch.full((n_global // WORLD,), float(RANK + 1))
arr = multihost.make_global_pixel_array(local, mesh)
total = all_reduce_(local.sum().reshape(1), mesh)
OUT["slice"] = np.array([sl.start, sl.stop])
OUT["arr"] = arr.numpy()
OUT["total"] = total.numpy()
"""


def test_two_process_initialize_and_gather(tmp_path):
    """Two gloo ranks: initialize is idempotent, the global array is the
    ranks' shards in order, a psum sums them (the JAX smoke test's
    reduction)."""
    outs = run_ranks(tmp_path, 2, _BODY_INIT, {})
    n_local = tmh.padded_global_size(10, 2) // 2
    expect = np.repeat([1.0, 2.0], n_local)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["slice"],
                                      [r * n_local, (r + 1) * n_local])
        np.testing.assert_array_equal(out["arr"], expect)
        assert float(out["total"][0]) == expect.sum()
