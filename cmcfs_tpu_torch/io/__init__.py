"""NetCDF-3 output and project file lookup (host side).

Copies of ``cmcfs_tpu/io``, kept equal to them apart from import paths."""
