"""Differentiable-rendering extensions beyond plain autodiff (port of
diff/).

`boundary`: the silhouette/visibility gradient term, the part of the pixel
gradient that autodiff at a fixed hit topology cannot see.
"""

from visionaray_torch.diff.boundary import (  # noqa: F401
    EdgeAdjacency, boundary_image, build_edge_adjacency,
    shadow_boundary_image, silhouette_mask, sphere_boundary_image,
)
