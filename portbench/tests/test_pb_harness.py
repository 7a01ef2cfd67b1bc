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


# the toy on the first ``cards`` of the cell's cards, one field a card
TOY_CARDS_KIND = TOY_KIND + '''

class Cards(Case):
    def __init__(self, cfg, devices, seed):
        self.parts = [Case(cfg, d, seed + k)
                      for k, d in enumerate(devices[:cfg["cards"]])]
        self.cells = cfg["n"] * len(self.parts)

    def step(self, i, traced=False):
        for p in self.parts:
            p.step(i, traced)

    def warm_up(self):
        for p in self.parts:
            p.warm_up()

    def held(self, pre):
        return self.parts[0].done

    def judge(self, limits, failed):
        gap = max(p.judge(limits, failed)[0]["gap"]["value"]
                  for p in self.parts)
        return ({"gap": {"value": gap, "limit": limits["gap"]},
                 "steps_failed": {"value": failed, "limit": 0}}, {})


def build(cfg, traffic, device, seed, shape=None, control=False,
          devices=None):
    return Cards(cfg, devices, seed)
'''


def _add_cell(dst, name: str, kind: str, source: str, cfg: dict,
              traffic: dict, limits: dict, chips: int = 1):
    """A configuration ``name`` of ``kind`` (written from ``source``
    where given), its traffic and its cell ``name``, added as files and
    named in BENCHMARK.json."""
    pb = dst / "portbench"
    if source:
        (pb / f"kinds/{kind}.py").write_text(source)
    (pb / f"configs/{name}.json").write_text(json.dumps(
        dict(cfg, name=name, kind=kind)))
    (pb / f"traffic/{name}.json").write_text(json.dumps(
        dict(traffic, name=name)))
    (pb / f"workloads/{name}.json").write_text(json.dumps(
        {"name": name, "limits": limits}))
    bench = json.load(open(dst / "BENCHMARK.json"))
    bench["configs"].append({"name": name, "source": "none",
                             "file": f"portbench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": name, "config": name,
                               "traffic": name, "chips": chips,
                               "why": "a test"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_kind_runs_from_files(tmp_path):
    """A configuration of a kind the harness has never seen, with its
    traffic, its cell and its ``build`` added as files (and named in
    BENCHMARK.json), runs end to end: the rehearsal prints its result."""
    dst = _copy(tmp_path)
    _add_cell(dst, "toy.small", "toy_decay", TOY_KIND,
              {"n": 4096, "rate": 0.999}, {"trace_steps": 2}, {"gap": 1e-6})
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


def _split_cell(tmp_path):
    """A checkout with the port and a cell whose traffic splits X over
    its two cards."""
    dst = _copy(tmp_path, with_port=True)
    cfg = json.load(open(dst / "portbench/configs/cavity_re1000.json"))
    _add_cell(dst, "cavity.split2", "lid_cavity_3d", None, cfg,
              {"grid_n": 24, "backend": "auto", "shards": 2,
               "trace_steps": 2}, {"step_gap": 3e-5, "err_gap": 1e-4},
              chips=2)
    return dst


def test_split_rehearsal_matches_reference(tmp_path):
    """A cell whose traffic splits X over its two cards, rehearsed on two
    CPU shards: the grid joined from the shards, the gathered states and
    the two steps equal the reference's (the pair form at 24^3, the
    resharded fused fallback on X at 260 x 10 x 10); the divergence
    error, summed shard by shard, within its limit."""
    dst = _split_cell(tmp_path)
    for grid in ("24", "260,10,10"):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "cavity.split2", "--seed", str(2 ** 31 + 9), "--seconds", "0",
             "--trace", "0", "--rehearse", "--grid", grid], cwd=dst,
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"], res["checks"]
        for name, c in res["checks"].items():
            if not name.endswith("err_gap"):
                assert c["value"] == 0, (grid, name, c)


def test_split_without_exchange_is_caught(tmp_path):
    """The split cell's run with the exchange of halo planes between the
    shards left out comes out not correct: the resharded slabs' halos
    then hold whatever their memory held, and the first step either
    trips the divergence gate or departs from the reference."""
    dst = _split_cell(tmp_path)
    code = (
        "import sys\nsys.path.insert(0, '.')\n"
        "from cmcfs_tpu_torch.parallel import mesh\n"
        "mesh.ShardingPlan.exchange = lambda self, slabs, dim: None\n"
        "from portbench import run\n"
        "sys.exit(run.main(['--workload', 'cavity.split2', '--seed', '13', "
        "'--seconds', '0', '--trace', '0', '--rehearse', '--grid', "
        "'24']))\n")
    out = _py(code, dst)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cards,trace", [(1, 0), (2, 0), (2, 1)])
def test_two_card_cell_counts_its_cards(tmp_path, cards, trace):
    """A cell with ``chips`` 2 whose case allocates only on cuda:0 exits
    with another code than 0, names its chips and the devices it used on
    standard error, and prints no result; the same case on both cards
    reports both, their memory and, traced, the trace of each."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dst = _copy(tmp_path)
    _add_cell(dst, "toy.cards", "toy_cards", TOY_CARDS_KIND,
              {"n": 4096, "rate": 0.999, "cards": cards},
              {"trace_steps": 2}, {"gap": 1e-6}, chips=2)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "toy.cards",
         "--seed", "7", "--seconds", "0.5", "--trace", str(trace)],
        cwd=dst, capture_output=True, text=True, timeout=300)
    if cards == 1:
        assert out.returncode != 0
        assert '"correct"' not in out.stdout
        assert "has chips 2" in out.stderr
        assert "used 1 device(s): cuda:0" in out.stderr
        return
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    dev = res["device"]
    assert dev["count"] == 2
    assert len(dev["memory_peak_bytes_each"]) == 2
    assert min(dev["memory_peak_bytes_each"]) > 0
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_each"])
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]


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
