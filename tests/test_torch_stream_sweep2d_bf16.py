"""The 2D stream sweep's bf16 payload mode against the Pallas stream kernel
in its 2D ``merge2d`` mode called with bf16 payloads (rhs and out_prev
rounded, ``pallas_sweep_stream.fused_sweep_stream`` in interpret mode; no
cmcfs_tpu path reaches it, as adi2d sends ``fused_bf16`` to the line
sweep), on test_torch_stream_sweep2d.py's lid cavity with a FREE outflow
side: X copying (``first``), Y averaging.  Every cell equal or one bf16
ulp apart (tests/torch_bf16.py); measured: no cell differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmcfs_tpu.models import adi2d as jadi
from cmcfs_tpu.ops.pallas_sweep_stream import fused_sweep_stream
from cmcfs_tpu_torch.models import adi2d as tadi
from cmcfs_tpu_torch.models.common2d import from_jax_numpy
from cmcfs_tpu_torch.ops import stream_sweep as ss

from test_torch_stream_sweep2d import setup_case
from torch_bf16 import assert_one_ulp


def _jax_bf16(ga, temp3, rhs3, out3, forcing, scal, axis, exact, first):
    """test_torch_stream_sweep2d._jax with the payloads rounded to bf16."""
    cls = ga.cls_x if axis == 0 else ga.cls_y
    arrs, batch = jadi._kernel_layout_2d(
        axis, [cls, ga.bct] + [jnp.asarray(f) for f in
                               (*temp3, *rhs3, *out3, forcing)])
    bf = jnp.bfloat16
    o3, t3 = fused_sweep_stream(
        jnp.stack(arrs[2:5]), arrs[0], arrs[1], arrs[1],
        jnp.stack(arrs[5:8]).astype(bf), jnp.stack(arrs[8:11]).astype(bf),
        arrs[11], jnp.asarray(scal), sweep_axis=0, axis_var=axis,
        exact=exact, t_var=2, bc2d=True, merge2d=True, first=first)
    assert o3.dtype == t3.dtype == bf

    def back(m):
        m = m.astype(jnp.float32).reshape(3, m.shape[1], -1)[:, :, :batch]
        return np.asarray(jnp.swapaxes(m, 1, 2) if axis == 1 else m)

    return back(o3), back(t3)


@pytest.mark.parametrize("axis, first, exact", [(0, True, False),
                                                (1, False, True)])
def test_stream_sweep_2d_bf16_matches_pallas(axis, first, exact):
    ga, pa, temp3, rhs3, out3 = setup_case(seed=5 + axis)
    st, tga, tpa = from_jax_numpy(tuple(temp3), ga, pa, "cpu")
    assert tadi.stream_ok_2d(tga) == (True, True)
    rng = np.random.default_rng(19 + axis)
    forcing = (0.1 * rng.standard_normal(temp3.shape[1:])).astype(np.float32)
    h = tpa.dx if axis == 0 else tpa.dy
    one = np.float32(1.0)
    scal = np.array([tpa.v_vis / (h * h), tpa.t_vis / (h * h),
                     one / np.float32(0.001), one / (np.float32(2.0) * h),
                     tpa.v_T], dtype=np.float32)
    o_j, t_j = _jax_bf16(ga, temp3, rhs3, out3, forcing, scal, axis, exact,
                         first)
    before = ss.bf16_launches.count
    o_t, t_t = ss.stream_sweep_2d(
        torch.tensor(temp3), tga.cls_x if axis == 0 else tga.cls_y, tga.bct,
        torch.tensor(rhs3).bfloat16(), torch.tensor(out3).bfloat16(),
        torch.tensor(forcing), scal, axis, exact, first)
    assert ss.bf16_launches.count == before     # CPU tensors: plain version
    assert o_t.dtype == t_t.dtype == torch.bfloat16
    assert_one_ulp(o_t, o_j, "out")
    assert_one_ulp(t_t, t_j, "tn")
