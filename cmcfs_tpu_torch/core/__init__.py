"""Cell and BC taxonomy, config and parameters, scene loaders (host side).

Copies of ``cmcfs_tpu/core``, kept equal to them apart from import paths."""
