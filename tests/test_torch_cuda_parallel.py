"""parallel/comm.py's transport with CUDA tensors on the card: two ranks
of a gloo group on one GPU (NCCL refuses two ranks on one device), each
sending a CUDA payload one hop round the ring and the gradient back; the
gloo group stages through host buffers, so the tensors come back on the
card with their values, and ``STATS`` counts the staged bytes.

Marked ``cuda``: skips itself when torch.cuda.is_available() is False
(decided inside the fixture, never at import).  On a GPU machine:

    python -m pytest tests/test_torch_cuda_parallel.py -q
"""

import pytest
import torch

from test_torch_multihost import run_ranks

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the gloo ranks stage CUDA tensors "
                    "(chip_smoke.py phases 22-23 run them on the H100)")
    return torch.device("cuda")


_BODY = """
from visionaray_torch.parallel import comm
mesh = comm.world_mesh()   # the harness's gloo group
dev = torch.device(str(INP["device"]))
x = torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3) \\
    + 100.0 * RANK
x.requires_grad_()
comm.reset_stats()
y = comm.hop(x, mesh)
(y * (RANK + 1.0)).sum().backward()
g = comm.all_gather(x.detach(), mesh)
s = comm.all_reduce_(torch.ones(2, device=dev) * (RANK + 1), mesh)
OUT["y"] = y.detach().cpu().numpy()
OUT["y_cuda"] = np.array(y.is_cuda)
OUT["grad"] = x.grad.cpu().numpy()
OUT["gather"] = g.cpu().numpy()
OUT["sum"] = s.cpu().numpy()
OUT["staged"] = np.array(comm.STATS["staged_bytes"])
"""


def test_gloo_hop_round_trip_of_cuda_tensors(cuda, tmp_path):
    outs = run_ranks(tmp_path, 2, _BODY, {"device": "cuda:0"})
    base = torch.arange(12, dtype=torch.float32).reshape(4, 3).numpy()
    for r, out in enumerate(outs):
        src = 1 - r
        assert bool(out["y_cuda"])
        assert (out["y"] == base + 100.0 * src).all()
        # y on rank r+1 was weighted by (r + 2): its gradient comes back
        assert (out["grad"] == float(src + 1)).all()
        assert (out["gather"][:4] == base).all()
        assert (out["gather"][4:] == base + 100.0).all()
        assert (out["sum"] == 3.0).all()
        assert int(out["staged"]) > 0   # gloo staged the CUDA tensors
