"""``python -m cmcfs_tpu_torch.verify`` on the CPU: ``scan`` against
``auto`` (the pair kernels' plain versions here) on a tiny box case with
a record a step agrees within the tool's 1e-5 rule and returns 0; the
bf16 payloads part by more and fail it; ``shards 2`` runs side B over 2
CPU shards."""
from cmcfs_tpu_torch import verify
from scripts.gen_box_case import gen


def _case(tmp_path):
    data, cfgp = gen(str(tmp_path / "case"), dx=0.05, time_steps=4,
                     num_global=4, num_local=2)
    with open(cfgp) as f:
        text = f.read()
    with open(cfgp, "w") as f:
        f.write(text.replace("out_time_steps \t1000000", "out_time_steps \t1"))
    return data, cfgp


def test_verify_scan_vs_auto(tmp_path, capsys):
    data, cfgp = _case(tmp_path)
    assert verify.main([data, cfgp, "steps", "2"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "[scan vs auto] -> OK" in out
    assert "u rec 1: rel diff" in out


def test_verify_catches_a_difference(tmp_path, capsys):
    """``fused_bf16`` stores the kernels' payloads in bf16, which parts
    from ``scan`` by far more than 1e-5: the tool reports it and returns
    1."""
    data, cfgp = _case(tmp_path)
    assert verify.main([data, cfgp, "scan", "fused_bf16", "steps", "2"],
                       device="cpu") == 1
    assert "above 1e-5" in capsys.readouterr().out


def test_verify_shards_refused(tmp_path, capsys):
    """``shards`` used to exit 2 (ROADMAP A8 part 1): side B now runs split
    over 2 CPU shards and agrees; without the cards it asks for, on the
    argv path, it exits 2 naming the visible count."""
    data, cfgp = _case(tmp_path)
    assert verify.main([data, cfgp, "steps", "2", "shards", "2"],
                       device="cpu") == 0
    out = capsys.readouterr().out
    assert "[scan vs auto on 2 shards] -> OK" in out
    assert "u rec 1: rel diff" in out
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert verify.main([data, cfgp, "shards", str(n + 2)]) == 2
    assert f"only {n} CUDA" in capsys.readouterr().err
