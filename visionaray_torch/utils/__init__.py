"""Utilities of the port: metrics, checkpoints, BVH debugging, the kernel
build directory (port of visionaray_tpu/utils/)."""
