"""PyTorch + CUDA port of cmcfs_tpu's 3D ADI main path.

The JAX package ``cmcfs_tpu`` is the reference; this package imports
``torch`` and never ``jax``.  It shares only the JAX-free host modules of
``cmcfs_tpu`` (config, params, types, scene and grid construction, line
classes, NetCDF writers, the CPU timer).

Layout:
  device.py            explicit device selection (CUDA or raise)
  ops/stencil.py       central differences, dissipation, divergence metric
  ops/tridiag.py       plain batched Thomas solve (reference operation order)
  ops/sweep_common.py  tridiagonal row build from the line classes
  ops/pair_sweep.py    the pair sweep: CUDA kernel wrapper + plain version
  kernels/             hand-written CUDA sources and their nvcc build
  models/              grid arrays, the ADI time step, the stateful solver
  cli3d.py             the fluidsolver3d command line
"""
