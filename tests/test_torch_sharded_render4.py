"""test_torch_sharded_render.py's frames at 4 ranks against JAX's
``make_mesh(4)`` (a file of its own, so the two world sizes run on
separate test workers)."""

import torch

from test_torch_sharded_render import (  # noqa: F401
    cornell_nee, make_frames, test_frame_matches_jax,
)

torch.set_num_threads(1)

frames = make_frames(4)
