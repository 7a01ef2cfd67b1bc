"""The harness: data-driven (a cell, a metric and a configuration kind
added as files are listed, and run, with no code edit), no JAX or JAX
package loaded, the reference free of the port, and no result without a
card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from _helpers import CHECKOUT

FORBIDDEN = {"jax", "jaxlib", "flax", "cmcfs_tpu"}


def _copy(tmp_path, with_port=False):
    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(CHECKOUT, "portbench"), dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), dst)
    if with_port:
        shutil.copytree(os.path.join(CHECKOUT, "cmcfs_tpu_torch"),
                        dst / "cmcfs_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _py(code, cwd):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_new_cell_and_metric_are_listed(tmp_path):
    dst = _copy(tmp_path)
    (dst / "portbench/workloads/cavity64.auto.json").write_text(json.dumps(
        {"name": "cavity64.auto", "limits": {"step_gap": 1, "err_gap": 1}}))
    (dst / "portbench/traffic/grid64.auto.json").write_text("{}")
    (dst / "portbench/metrics/pair_sweep.launches.py").write_text(
        "def read(rec):\n    return None\n")
    out = subprocess.run([sys.executable, "portbench/run.py", "--list"],
                         cwd=dst, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout)
    assert "cavity64.auto" in found["workloads"]
    assert "grid64.auto" in found["traffic"]
    assert "pair_sweep.launches" in found["metrics"]
    assert "_counts" not in found["metrics"]
    assert "_adi3d" not in found["kinds"]
    bench = json.load(open(dst / "BENCHMARK.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["name"] in found["metrics"]
    for w in bench["workloads"]:
        assert w["name"] in found["workloads"]
        assert w["traffic"] in found["traffic"]
        assert w["chips"] == 1
    for c in bench["configs"]:
        assert c["name"] in found["configs"]
        cfg = json.load(open(dst / c["file"]))
        assert cfg["kind"] in found["kinds"]


# a configuration kind of its own, added as files alone: a field that
# decays by a fixed factor each step, held against the same product taken
# in float64
TOY_KIND = '''
import torch


class Case:
    spans = ("decay",)
    warmup_steps = 1
    trace_from = 3
    failures = (FloatingPointError,)

    def __init__(self, cfg, device, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.x0 = torch.rand(cfg["n"], generator=gen, device=device)
        self.x, self.rate, self.done = self.x0.clone(), cfg["rate"], 0
        self.cells = cfg["n"]

    def label(self):
        return "toy"

    def step(self, i, traced=False):
        self.x = self.x * self.rate
        self.done += 1

    def warm_up(self):
        self.step(0)

    def checkable(self, i):
        return True

    def hold(self):
        return None

    def held(self, pre):
        return self.done

    def release(self, sample):
        pass

    def judge(self, limits, failed):
        ref = self.x0.double() * self.rate ** self.done
        gap = float((self.x.double() - ref).abs().max())
        return ({"gap": {"value": gap, "limit": limits["gap"]},
                 "steps_failed": {"value": failed, "limit": 0}}, {})


def build(cfg, traffic, device, seed, shape=None, control=False):
    return Case(cfg, device, seed)
'''


def test_new_kind_runs_from_files(tmp_path):
    """A configuration of a kind the harness has never seen, with its
    traffic, its cell and its builder added as files (and named in
    BENCHMARK.json), runs end to end: the rehearsal prints its result."""
    dst = _copy(tmp_path)
    pb = dst / "portbench"
    (pb / "kinds/toy_decay.py").write_text(TOY_KIND)
    (pb / "configs/toy.json").write_text(json.dumps(
        {"name": "toy", "kind": "toy_decay", "n": 4096, "rate": 0.999}))
    (pb / "traffic/toy.small.json").write_text(json.dumps(
        {"name": "toy.small", "trace_steps": 2}))
    (pb / "workloads/toy.small.json").write_text(json.dumps(
        {"name": "toy.small", "limits": {"gap": 1e-6}}))
    bench = json.load(open(dst / "BENCHMARK.json"))
    bench["configs"].append({"name": "toy", "source": "none",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.small", "config": "toy",
                               "traffic": "toy.small", "chips": 1,
                               "why": "a test"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "toy.small",
         "--seed", str(2 ** 33 + 1), "--seconds", "0.2", "--trace", "0",
         "--rehearse"], cwd=dst, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["metrics"] == {}
    assert "check gap:" in out.stderr


def test_modules_load_no_jax():
    code = (
        "import sys, glob, os, importlib\n"
        "sys.path.insert(0, '.')\n"
        "import runpy\n"
        "runpy.run_path('portbench/run.py', run_name='portbench_run')\n"
        "from portbench import registry, check, trace\n"
        "from portbench.reference import grid, adi\n"
        "for n in registry.listing()['metrics']: registry.reader(n)\n"
        "for n in registry.listing()['kinds']: registry.builder(n)\n"
        "import cmcfs_tpu_torch.models.solver3d, cmcfs_tpu_torch.cli3d\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _py(code, CHECKOUT)
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = ("import sys\nsys.path.insert(0, '.')\n"
            "from portbench.reference import grid, adi\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _py(code, CHECKOUT)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert "cmcfs_tpu_torch" not in names
    assert not names & FORBIDDEN


@pytest.mark.parametrize("with_port", [False, True])
def test_no_card_no_result(tmp_path, with_port):
    """Without a card (or without the port beside it) a cell's run exits
    with another code than 0 and prints no result."""
    import torch
    if torch.cuda.is_available() and with_port:
        pytest.skip("a card is present: the run would measure")
    dst = _copy(tmp_path, with_port)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cavity256.auto",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=dst, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.mark.gpu
def test_cell_on_the_card():
    """The baffle cell's run on a card: correct, every end-to-end metric
    reported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "baffle256.auto",
         "--seed", "3", "--seconds", "2", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert {"cell_updates_per_s", "step_ms_p95", "setup_s"} <= set(
        res["metrics"])
