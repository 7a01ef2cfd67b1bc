"""PyTorch + CUDA port of cmcfs_tpu's 3D and 2D solvers (ADI, Explicit,
Stable) on one device.

The JAX package ``cmcfs_tpu`` is the reference; this package imports
``torch`` and never ``jax``, and nothing of ``cmcfs_tpu``: it keeps its
own copies of the JAX-free host modules it needs (``core/``, ``geom/``,
``ops/masks.py``, ``io/``, ``utils/timer.py``; ``io/checkpoint.py`` keeps
two of its three tiers), equal to the originals apart from import paths
and where the native geometry engine is built.

Layout:
  device.py            explicit device selection (CUDA or raise)
  core/ geom/ io/      host side: config, params, scenes, grids, NetCDF
  ops/masks.py         line classes (segments -> dense row classes)
  ops/stencil.py       central differences, dissipation, divergence metrics
  ops/tridiag.py       batched Thomas solve: plain version and backends
  ops/tridiag_rows.py  Thomas on materialized rows: CUDA kernel wrapper
  ops/sweep_common.py  tridiagonal row build from the line classes
  ops/pair_sweep.py    the pair sweep: CUDA kernel wrapper + plain version
  ops/stream_sweep.py  one local iteration with a caller-built forcing
  ops/line_sweep.py    row build + Thomas on a caller-built RHS
  kernels/             hand-written CUDA sources and their nvcc build
  models/              grid arrays, the ADI, Explicit and Stable time steps,
                       the Poisson loop, the stateful solvers
  utils/profiler.py    named sections ended by a device synchronize
  cli3d.py, cli2d.py   the fluidsolver3d and fluidsolver2d command lines
  verify.py            one case on two backends, the outputs diffed
"""
