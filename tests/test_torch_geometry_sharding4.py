"""test_torch_geometry_sharding.py's tests at 4 ranks against JAX's
``make_mesh(4)`` (a file of its own, so the two world sizes run on
separate test workers)."""

import torch

from test_torch_geometry_sharding import (  # noqa: F401
    make_runs, setup, test_any_hits_match_jax, test_closest_hits_match_jax,
    test_soup_gradients_match_jax,
)

torch.set_num_threads(1)

runs = make_runs(4)
