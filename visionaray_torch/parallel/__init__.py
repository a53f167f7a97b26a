"""Rendering over several ranks (port of visionaray_tpu/parallel/): tile
sharding of the pixels, geometry sharding with a ring of ray batches, and
the geometry-sharded path tracer, over torch.distributed process groups."""
