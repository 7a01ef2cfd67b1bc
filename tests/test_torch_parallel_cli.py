"""The X split's plan and its user surfaces on the CPU: ``make_x_mesh``
never picks fewer cards or the CPU by itself; ``ShardingPlan``'s split,
gather, halo exchange and reshard; ``cli3d.run_case(..., shards=4)``
writes the single device's NetCDF file byte for byte (the bench box at
22^3, whose last X plane holds IN cells and whose 22 planes do not divide
by 4); ``checkpoint`` / ``resume`` over shards; the refusals that remain
(the profiled ADI step, more shards than planes) and the runs that were
refusals (``blocking``, Explicit and Stable split over devices)."""
import os

import pytest
import torch

from cmcfs_tpu_torch import cli3d
from cmcfs_tpu_torch.core.params import FluidParams
from cmcfs_tpu_torch.geom.synthetic import lid_cavity_3d
from cmcfs_tpu_torch.models.solver3d import SolverError, make_solver_3d
from cmcfs_tpu_torch.parallel.mesh import ShardingPlan, even_cuts, make_x_mesh
from cmcfs_tpu_torch.utils.profiler import Profiler
from scripts.gen_box_case import gen


def test_make_x_mesh_never_picks_fewer_cards_or_the_cpu(monkeypatch):
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"only {visible} CUDA"):
        make_x_mesh(visible + 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_x_mesh(2).devices == (torch.device("cuda", 0),
                                      torch.device("cuda", 1))
    assert make_x_mesh().n == 2
    with pytest.raises(ValueError, match="only 2 CUDA"):
        make_x_mesh(3)
    # an explicit list is taken as it is; the CPU only when asked for
    plan = make_x_mesh(devices=["cuda:0"] * 4)
    assert plan.devices == (torch.device("cuda", 0),) * 4
    assert make_x_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        make_x_mesh(5, devices=["cpu"] * 4)


@pytest.mark.parametrize("cuts", [[3, 3, 3], [4, 2, 2, 1], [9]])
def test_plan_split_gather_exchange_reshard(cuts):
    """Slabs hold the planes they own and periodic halos (torch.roll's
    wrap); an exchange after a change refreshes the halos; the reshard to
    Y slabs and back gives the same array."""
    plan = ShardingPlan(["cpu"] * len(cuts))
    a = torch.arange(2 * 9 * 7 * 3, dtype=torch.float32).reshape(2, 9, 7, 3)
    slabs = plan.split(a, -3, cuts)
    assert torch.equal(plan.gather(slabs, -3), a)
    start = 0
    for t, c in zip(slabs, cuts):
        idx = torch.arange(start - 1, start + c + 1) % 9
        assert torch.equal(t, a[:, idx])
        start += c
    for t in slabs:
        t[:, 1:-1] += 1.0
        t[:, 0] = t[:, -1] = -7.0
    plan.exchange(slabs, -3)
    assert torch.equal(torch.cat([t[:, 1:-1] for t in slabs], 1), a + 1)
    start = 0
    for t, c in zip(slabs, cuts):
        idx = torch.arange(start - 1, start + c + 1) % 9
        assert torch.equal(t, (a + 1)[:, idx])
        start += c
    ys = plan.reshard(slabs, -3, -2, even_cuts(7, plan.n))
    plan.exchange(ys, -2)
    assert torch.equal(plan.gather(ys, -2), a + 1)
    back = plan.reshard(ys, -2, -3, cuts)
    assert torch.equal(plan.gather(back, -3), a + 1)


def _box(tmp_path):
    data, cfgp = gen(str(tmp_path / "case"), dx=0.05, time_steps=4,
                     num_global=2, num_local=2)
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000",
                             "out_time_steps \t1"))
    return data, cfgp


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_run_case_shards_writes_the_same_netcdf(tmp_path):
    data, cfgp = _box(tmp_path)
    base = str(tmp_path / "out")
    one, e1 = cli3d.run_case(data, base + "1", cfgp, quiet=True,
                             max_steps=3, collect_errs=True, device="cpu")
    four, e4 = cli3d.run_case(data, base + "4", cfgp, quiet=True,
                              max_steps=3, collect_errs=True, device="cpu",
                              shards=4)
    assert one.grid.dimx == 22 and four.x_cuts == [6, 6, 6, 4]
    assert (one.grid.types[-1] == 0).any()     # IN cells on the last plane
    assert _bytes(base + "1_res.nc") == _bytes(base + "4_res.nc")
    for a, b in zip(e1, e4):
        assert abs(a - b) <= 1e-6 * abs(a)
    for s1, s4 in zip(one.state(), four.state()):
        assert torch.equal(torch.stack(tuple(s1)), torch.stack(tuple(s4)))


def test_checkpoint_resume_over_shards(tmp_path):
    """Two steps with a checkpoint and two resumed, over 3 shards, equal
    four straight; the checkpoint holds the whole grid, as one device's
    does, and resumes on one device too."""
    data, cfgp = _box(tmp_path)
    base = str(tmp_path / "o")

    def run(name, shards, **kw):
        return cli3d.run_case(data, base + name, cfgp, quiet=True,
                              device="cpu", shards=shards, **kw)[0]

    straight = run("s", 3, max_steps=4)
    run("p", 3, max_steps=2, checkpoint=base + "ck3")
    run("q", 1, max_steps=2, checkpoint=base + "ck1")
    assert _bytes(base + "ck3.npz") == _bytes(base + "ck1.npz")
    resumed = run("p", 3, max_steps=2, resume=base + "ck3.npz")
    on_one = run("q", 1, max_steps=2, resume=base + "ck3.npz")
    for s in (resumed, on_one):
        for a, b in zip(straight.state(), s.state()):
            assert torch.equal(torch.stack(tuple(a)), torch.stack(tuple(b)))
    assert _bytes(base + "s_res.nc") == _bytes(base + "p_res.nc")


def test_refusals_under_a_plan():
    """What a plan still refuses: the profiled ADI step and a split into
    more shards than X planes.  ``set_plan(nblockz=2)`` (A8 part 2) and
    the Explicit and Stable schemes under a plan (A8 part 4) used to be
    refused; each now runs a step, bit for bit its single device's."""
    grid = lid_cavity_3d(12, 10, 9)
    params = FluidParams.normalized(200.0, 0.72, 1.4)

    def step(name, backend="auto", **plan):
        s = make_solver_3d(name, backend=backend, device="cpu")
        s.init(grid, params)
        if plan:
            s.set_plan(make_x_mesh(devices=["cpu"] * 2), **plan)
        s.update_boundaries()
        s.time_step(0.002, 2, 2)
        return s, torch.stack(tuple(s.state()[0]))

    adi, blocked = step("ADI", "scan", nblockz=2)
    assert adi.plan.nblockz == 2
    assert torch.equal(blocked, step("ADI", "scan")[1])
    with pytest.raises(SolverError, match="single-device"):
        adi.time_step_profiled(0.01, 1, 2, Profiler(device="cpu"))
    for name in ("Explicit", "Stable"):
        s, split = step(name, nblockz=0)
        assert s.plan.n == 2
        assert torch.equal(split, step(name)[1])
    with pytest.raises(SolverError, match="too few"):
        tiny = make_solver_3d("ADI", device="cpu")
        tiny.init(lid_cavity_3d(5, 6, 6), params)
        tiny.set_plan(make_x_mesh(devices=["cpu"] * 4))


def test_cli_dispatch_line_names_the_shards(tmp_path, capsys):
    data, cfgp = _box(tmp_path)
    base = str(tmp_path / "d")
    assert cli3d.main([data, base, cfgp, "shards", "2"], device="cpu") == 0
    assert "shards=2" in capsys.readouterr().out
    assert os.path.getsize(base + "_res.nc") > 0
