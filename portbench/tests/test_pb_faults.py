"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell of this benchmark can have: a step that
returns its state unchanged, half of the grid's lines left out of the
step (their cells keep the old state), and one value altered where the
step produces it.  (No cell spans chips; a split cell's exchange left
out is ``test_pb_harness.test_split_without_exchange_is_caught``.)"""
import pytest
import torch

from _helpers import rehearse


def _unchanged(cur, nxt, new):
    return torch.stack(tuple(cur))


def _half(cur, nxt, new):
    old = torch.stack(tuple(cur))
    nx = old.shape[1]
    return torch.cat((new[:, : nx // 2], old[:, nx // 2:]), dim=1)


def _altered(cur, nxt, new):
    out = new.clone()
    n = out.shape[1] // 2
    out[0, n, n, n] += 1e-3
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_fault_is_caught(capsys, monkeypatch, fault):
    from cmcfs_tpu_torch.models import adi3d
    from cmcfs_tpu_torch.models.common3d import State3D

    real = adi3d.adi_timestep_3d

    def broken(cur, nxt_prev, *a, **k):
        new, err = real(cur, nxt_prev, *a, **k)
        out = fault(cur, nxt_prev, torch.stack(tuple(new)))
        return State3D(*out.unbind(0)), err

    monkeypatch.setattr(adi3d, "adi_timestep_3d", broken)
    res = rehearse(capsys, "baffle256.auto", 21)
    assert not res["correct"], res["checks"]
    assert res["checks"]["first_step_gap"]["value"] > \
        res["checks"]["first_step_gap"]["limit"]
