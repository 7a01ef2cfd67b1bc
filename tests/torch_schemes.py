"""Shared inputs of the Explicit and Stable scheme tests
(tests/test_torch_{explicit,stable}{3d,2d}.py): the lid cavities of
tests/test_solvers3d_ext.py and tests/test_solvers2d.py at small size,
random states made from a seed with numpy, both packages' arrays built
from them, and the field check.

Tolerance: the repo's gate is 1e-5 * max(1, max|field|) per variable; the
scheme tests hold the tighter REL = 1e-6 (their PyTorch ops follow
cmcfs_tpu's order of operations, so the two part by a few float32 ulps
where XLA contracts a product and a sum into an FMA; measured 1.5e-8
to 2.2e-7 of max(1, max|field|)).
"""
import numpy as np
import torch

from cmcfs_tpu.core.params import FluidParams
from cmcfs_tpu.core.types import NodeType

REL = 1e-6
PARAMS3D = FluidParams.normalized(200.0, 0.72, 1.4)
PARAMS2D = FluidParams.normalized(150.0, 0.72, 1.4)


def cavity3d(n: int):
    """tests/test_solvers3d_ext.py's lid cavity at n^3: (grid, jax
    (cur, ga, pa), port (cur, ga, pa))."""
    import jax.numpy as jnp
    from cmcfs_tpu.geom.synthetic import lid_cavity_3d
    from cmcfs_tpu.models import adi3d as jadi
    from cmcfs_tpu.models import common3d as jc
    from cmcfs_tpu_torch.models import adi3d, common3d
    grid = lid_cavity_3d(n, n, n, dx=0.02, lid_velocity=0.2)
    pa = adi3d.make_params(PARAMS3D, grid.dx, grid.dy, grid.dz)
    jpa = jadi.ParamsArgs3D(*(jnp.float32(x) for x in pa))
    return (grid, (jc.init_state(grid), jc.grid_arrays(grid), jpa),
            (common3d.init_state(grid, "cpu"),
             common3d.grid_arrays(grid, "cpu"), pa))


def cavity2d(nx: int, ny: int):
    """tests/test_solvers2d.py's synthetic lid cavity: (grid, jax (cur,
    ga, pa), port (cur, ga, pa))."""
    import jax.numpy as jnp
    from cmcfs_tpu.geom.synthetic import lid_cavity_2d
    from cmcfs_tpu.models import adi2d as jadi
    from cmcfs_tpu.models import common2d as jc
    from cmcfs_tpu_torch.models import adi2d, common2d
    grid = lid_cavity_2d(nx, ny, dx=0.01, lid_velocity=0.4)
    pa = adi2d.make_params(PARAMS2D, grid.dx, grid.dy, grid.start_T)
    jpa = jadi.ParamsArgs(*(jnp.float32(x) for x in pa))
    return (grid, (jc.init_state(grid), jc.grid_arrays(grid), jpa),
            (common2d.init_state(grid, "cpu"),
             common2d.grid_arrays(grid, "cpu"), pa))


def random_state(cur, types, seed: int, scale: float = 0.05):
    """Numpy fields: cur's values plus seeded noise on NODE_IN cells (the
    BOUND/VALVE cells keep their grid values)."""
    rng = np.random.default_rng(seed)
    is_in = np.asarray(types) == NodeType.IN
    out = []
    for f in cur:
        a = np.asarray(f).astype(np.float32)
        noise = (scale * rng.standard_normal(a.shape)).astype(np.float32)
        out.append(np.where(is_in, a + noise, a).astype(np.float32))
    return out


def both(fields, jax_type, port_type):
    """The same numpy fields as a JAX state and as the port's."""
    import jax.numpy as jnp
    return (jax_type(*(jnp.asarray(f) for f in fields)),
            port_type(*(torch.tensor(f) for f in fields)))


def assert_close(got, want, rel: float = REL) -> float:
    """Each port field within rel * max(1, max|want|) of cmcfs_tpu's, NaN
    where cmcfs_tpu has NaN; returns the largest difference over that
    bound."""
    worst = 0.0
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape
        bound = rel * max(1.0, float(np.nanmax(np.abs(w))))
        np.testing.assert_allclose(g, w, rtol=0, atol=bound, equal_nan=True)
        worst = max(worst, float(np.nanmax(np.abs(g - w))) / bound)
    return worst
