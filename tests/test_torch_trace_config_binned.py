"""The binned path's switches of TraceConfig vs the JAX package on the CPU:
the frame of test_torch_trace_config.py under shadow_m=6 and dir_bits=3
(VSNRAY_SHADOW_M=6, VSNRAY_DIRBITS=3: six treelet slots for the NEE
shadow rays, three in-octant direction bits in the binned sort key), with
its image tolerance."""

import pytest
import torch

from test_torch_trace_config import check_frame

from visionaray_torch.ops.trace import TraceConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["shadow_m6_dir_bits3"])
def test_frame_matches_jax_under_switch(name, monkeypatch):
    check_frame(TraceConfig(shadow_m=6, dir_bits=3),
                {"closest", "any", "binned_closest", "binned_any"},
                monkeypatch)
