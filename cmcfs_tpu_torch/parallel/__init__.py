"""The 3D solver split over X across devices (port of cmcfs_tpu/parallel)."""
