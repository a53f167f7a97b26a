"""Row 1f's half-cluster skip vs the JAX package on the CPU: the four front
ends of the port against JAX's under VSNRAY_HALFSKIP=1, on
test_torch_fanout.py's K=16, T=4 fixture (half boxes in records 0 and 1)
and with its tolerances (hit equal, t rtol 1e-5, prim equal where the
nearest hit is unique)."""

import jax
import pytest
import torch

from test_torch_fanout import (
    FRONT_ENDS, check_front_end, fixture_k16, jax_switches,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def k16():
    return fixture_k16()


@pytest.mark.parametrize("name", FRONT_ENDS)
def test_half_skip_front_ends_match_jax(k16, name, monkeypatch):
    jax_switches(monkeypatch, half_skip=True)
    try:
        check_front_end(k16, name, fanout=2, half_skip=True)
    finally:
        jax.clear_caches()
