"""File I/O of the port: images, pixel formats, OBJ/MTL, camera files
(port of visionaray_tpu/io/)."""
