"""Row 1f at fanout 8 vs the JAX package on the CPU: the four front ends of
the port against JAX's under VSNRAY_FANOUT=8, on test_torch_fanout.py's
K=16, T=4 fixture and with its tolerances (hit equal, t rtol 1e-5, prim
equal where the nearest hit is unique)."""

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
def test_fanout8_front_ends_match_jax(k16, name, monkeypatch):
    jax_switches(monkeypatch, fanout=8)
    try:
        check_front_end(k16, name, fanout=8, half_skip=False)
    finally:
        jax.clear_caches()
