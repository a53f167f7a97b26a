"""test_torch_sharded_grad.py's tests at 4 ranks against JAX's
``make_mesh(4)`` (a file of its own, so the two world sizes run on
separate test workers)."""

import torch

from test_torch_sharded_grad import (  # noqa: F401
    cornell_nee, make_grads, test_loss_matches_jax,
    test_replicated_material_gradient_matches_jax,
    test_soup_gradient_matches_jax,
)

torch.set_num_threads(1)

grads = make_grads(4)
