"""Host grid construction: 2D rasterization, 3D grids, the native engine.

Copies of ``cmcfs_tpu/geom``, kept equal to them apart from import paths
and where the native engine is built."""
