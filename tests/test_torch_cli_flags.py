"""The single-card flags of the port's cli3d on the CPU against
cmcfs_tpu: ``profile`` times the step under cmcfs_tpu's event names and
computes what the unprofiled step computes, bit for bit; ``dump_grid``
writes the BMP files cmcfs_tpu's ``mask_to_bmp_stack`` writes, byte for
byte; ``carried`` prints cmcfs_tpu's note and gives the per-step run's
records, byte for byte."""
import inspect
import os

import jax.numpy as jnp
import torch

from cmcfs_tpu import cli3d as jcli
from cmcfs_tpu.io.image import mask_to_bmp_stack
from cmcfs_tpu.models import adi3d as jadi
from cmcfs_tpu.utils.profiler import Profiler as JaxProfiler
from cmcfs_tpu_torch import cli3d
from cmcfs_tpu_torch.models import adi3d
from cmcfs_tpu_torch.models.common3d import merge_ok
from cmcfs_tpu_torch.utils.profiler import Profiler
from scripts.gen_box_case import gen
from tests.torch_schemes import cavity3d


def _case(tmp_path, time_steps=4):
    data, cfgp = gen(str(tmp_path / "case"), dx=0.05, time_steps=time_steps,
                     num_global=2, num_local=2)
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000", "out_time_steps \t1"))
    return data, cfgp


def test_profile_events_match_jax():
    """One profiled step: the event names and counts of cmcfs_tpu's
    profiled step; the fields equal ``adi_timestep_3d``'s bit for bit."""
    grid, (jcur, jga, jpa), (cur, ga, pa) = cavity3d(12)
    jprof = JaxProfiler(sync=False)
    jadi.adi_timestep_3d_profiled(jcur, jcur, jga, jnp.float32(0.01), 2, 2,
                                  jpa, jprof, backend="scan",
                                  merge_ok=(False,) * 3)
    prof = Profiler(device="cpu")
    mok = merge_ok(ga)
    got, err = adi3d.adi_timestep_3d_profiled(cur, cur, ga, 0.01, 2, 2, pa,
                                              prof, merge_ok=mok)
    want, werr = adi3d.adi_timestep_3d(cur, cur, ga, 0.01, 2, 2, pa,
                                       merge_ok=mok)
    assert {k: e.count for k, e in prof.events.items()} == \
        {k: e.count for k, e in jprof.events.items()}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert err == float(werr)
    assert "SolveSegments_Z" in prof.report() and prof.report(csv=True)


def test_cli_profile_equals_plain_run(tmp_path, capsys):
    data, cfgp = _case(tmp_path)
    a, _ = cli3d.run_case(data, str(tmp_path / "plain"), cfgp, quiet=True,
                          device="cpu")
    b, _ = cli3d.run_case(data, str(tmp_path / "prof"), cfgp, profile=True,
                          device="cpu")
    table = capsys.readouterr().out
    for name in ("UpdateBoundaries", "CopyLayer", "SolveSegments_X",
                 "MergeLayer", "EvalDivError", "Output"):
        assert name in table
    with open(tmp_path / "plain_res.nc", "rb") as f1, \
            open(tmp_path / "prof_res.nc", "rb") as f2:
        assert f1.read() == f2.read()
    for x, y in zip(a.cur, b.cur):
        assert torch.equal(x, y)


def test_dump_grid_bytes_equal_jax(tmp_path):
    data, cfgp = _case(tmp_path, time_steps=2)
    assert cli3d.main([data, str(tmp_path / "port"), cfgp, "dump_grid",
                       "quiet"], device="cpu") == 0
    grid = jcli.build_grid(jcli.Config.load(cfgp), data)
    mask_to_bmp_stack(grid.types, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == grid.dimz
    assert sorted(os.listdir(tmp_path / "port_grid_3d")) == names
    for n in names:
        with open(tmp_path / "jax" / n, "rb") as f1, \
                open(tmp_path / "port_grid_3d" / n, "rb") as f2:
            assert f1.read() == f2.read(), n


def test_carried_equals_per_step(tmp_path, capsys):
    data, cfgp = _case(tmp_path)
    a, _ = cli3d.run_case(data, str(tmp_path / "step"), cfgp, quiet=True,
                          device="cpu")
    b, _ = cli3d.run_case(data, str(tmp_path / "carr"), cfgp, carried=True,
                          device="cpu")
    assert cli3d.CARRIED_NOTE in capsys.readouterr().err
    src = inspect.getsource(jcli.run_case)       # cmcfs_tpu's words
    assert all(part in src for part in cli3d.CARRIED_NOTE.split("— "))
    with open(tmp_path / "step_res.nc", "rb") as f1, \
            open(tmp_path / "carr_res.nc", "rb") as f2:
        assert f1.read() == f2.read()
    for sa, sb in ((a.cur, b.cur), (a.next, b.next)):
        for x, y in zip(sa, sb):
            assert torch.equal(x, y)
