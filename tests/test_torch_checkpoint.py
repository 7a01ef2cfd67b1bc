"""Checkpoint and resume in the port (cmcfs_tpu_torch/io/checkpoint.py,
the ``checkpoint``/``resume`` flags of cli3d and cli2d) on the CPU: an
interrupted and resumed run equals the uninterrupted one bit for bit (3D:
the state and the NetCDF file byte for byte; 2D: the state and the CDL
frames), an npz written by cmcfs_tpu.io.checkpoint loads in the port and
one written by the port loads in cmcfs_tpu, and the legacy text layer
round-trips (as tests/test_checkpoint.py holds cmcfs_tpu's)."""
import numpy as np
import torch

from cmcfs_tpu.io import checkpoint as jck
from cmcfs_tpu_torch import cli2d, cli3d
from cmcfs_tpu_torch.io import checkpoint as tck
from scripts.gen_box_case import gen, gen_2d
from tests.test_parity_2d import parse_cdl_frames


def _every_step(cfgp):
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000", "out_time_steps \t1"))


def _same_state(a, b):
    for sa, sb in ((a.cur, b.cur), (a.next, b.next)):
        for x, y in zip(sa, sb):
            assert torch.equal(x, y)


def test_3d_resume_exact(tmp_path):
    """5 steps straight against 2 with ``checkpoint``, then ``resume`` to
    the same output base, which appends the remaining records."""
    data, cfgp = gen(str(tmp_path / "case"), dx=0.05, time_steps=6,
                     num_global=2, num_local=2)
    _every_step(cfgp)
    full, _ = cli3d.run_case(data, str(tmp_path / "full"), cfgp, quiet=True,
                             device="cpu")
    ck = str(tmp_path / "ck")
    cli3d.run_case(data, str(tmp_path / "part"), cfgp, quiet=True,
                   max_steps=2, checkpoint=ck, device="cpu")
    part, _ = cli3d.run_case(data, str(tmp_path / "part"), cfgp, quiet=True,
                             resume=ck + ".npz", device="cpu")
    _same_state(full, part)
    with open(tmp_path / "full_res.nc", "rb") as f1, \
            open(tmp_path / "part_res.nc", "rb") as f2:
        assert f1.read() == f2.read()


def test_2d_resume_exact(tmp_path):
    data, cfgp = gen_2d(str(tmp_path / "case"), dx=0.025, time_steps=6)
    _every_step(cfgp)
    full, _, _ = cli2d.run_case(data, "", str(tmp_path / "full.cdl"), cfgp,
                                quiet=True, device="cpu")
    ck = str(tmp_path / "ck")
    cli2d.run_case(data, "", str(tmp_path / "p1.cdl"), cfgp, quiet=True,
                   max_steps=2, checkpoint=ck, device="cpu")
    dimx, dimy = full.ga.types.shape
    with open(ck + ".lastlayer.txt") as f:      # frame 0, the dimensions
        assert f.read().split()[:3] == ["0", str(dimx), str(dimy)]
    part, _, _ = cli2d.run_case(data, "", str(tmp_path / "p2.cdl"), cfgp,
                                quiet=True, resume=ck + ".npz", device="cpu")
    _same_state(full, part)
    f_full = parse_cdl_frames(str(tmp_path / "full.cdl"), 50, 50)
    f1 = parse_cdl_frames(str(tmp_path / "p1.cdl"), 50, 50)
    f2 = parse_cdl_frames(str(tmp_path / "p2.cdl"), 50, 50)
    assert len(f1) == 2 and len(f1) + len(f2) == len(f_full) > 3
    np.testing.assert_array_equal(np.concatenate([f1, f2]), f_full)


def test_npz_interchange(tmp_path):
    """A checkpoint of either package loads in the other with the same
    step, time, names, dtypes and values."""
    rng = np.random.default_rng(0)
    fields = {k: rng.standard_normal((5, 4, 3)).astype(np.float32)
              for k in ("u", "v", "w", "T", "nu", "nv", "nw", "nT")}
    for save, load in ((jck.save_checkpoint, tck.load_checkpoint),
                       (tck.save_checkpoint, jck.load_checkpoint)):
        p = str(tmp_path / save.__module__.replace(".", "_"))
        save(p, 7, 1.75, **fields)
        step, t, got = load(p + ".npz")
        assert (step, t) == (7, 1.75)
        assert sorted(got) == sorted(fields)
        for k, a in fields.items():
            assert got[k].dtype == a.dtype
            np.testing.assert_array_equal(got[k], a)


def test_legacy_text_layer_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    u, v, T = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3))
    p = str(tmp_path / "layer.txt")
    tck.save_last_layer_txt(p, 3, u, v, T)
    frame, u2, v2, T2 = tck.load_last_layer_txt(p, 6, 5, frames=10)
    assert frame == 3
    for a, b in ((u, u2), (v, v2), (T, T2)):
        np.testing.assert_allclose(b, a, atol=1e-6)
    assert jck.load_last_layer_txt(p, 6, 5, frames=10)[0] == 3
    # dimension mismatch -> None (the reference returns 0)
    assert tck.load_last_layer_txt(p, 7, 5, frames=10) is None
