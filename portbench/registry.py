"""Finding a cell's configuration, traffic, limits, case builder and metric
readers by the names in ``BENCHMARK.json``: one file each, so that a cell,
a configuration kind or a metric is added as files, with no edit of the
harness."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
KINDS = {"configs": ".json", "traffic": ".json", "workloads": ".json",
         "kinds": ".py", "metrics": ".py"}


def _path(kind: str, name: str, root: str = HERE) -> str:
    return os.path.join(root, kind, name + KINDS[kind])


def load_json(kind: str, name: str, root: str = HERE) -> dict:
    """``<root>/<kind>/<name>.json``."""
    with open(_path(kind, name, root)) as f:
        return json.load(f)


def listing(root: str = HERE) -> dict:
    """Every name each folder holds ("_" files are shared helpers)."""
    out = {}
    for kind, ext in KINDS.items():
        d = os.path.join(root, kind)
        names = (sorted(f[:-len(ext)] for f in os.listdir(d)
                        if f.endswith(ext) and not f.startswith("_"))
                 if os.path.isdir(d) else [])
        out[kind] = names
    return out


def benchmark(checkout: str) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: the end-to-end
    ones without a trace, the per-layer ones with it, each where its
    ``workloads`` list, if it has one, names the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def _module(kind: str, name: str, root: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_"),
        _path(kind, name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = HERE):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    return _module("metrics", name, root).read


def builder(kind: str, root: str = HERE):
    """The ``build(cfg, traffic, device, seed, shape, control)`` function
    of ``kinds/<kind>.py``, the configuration's ``kind``."""
    return _module("kinds", kind, root).build
