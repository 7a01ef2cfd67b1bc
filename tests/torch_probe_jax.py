"""Run the JAX probe scripts' Pallas kernels on the CPU and record them, for
the tests that hold the port's probes (cmcfs_tpu_torch/probes) against
them.

``interpret_pallas(monkeypatch)`` only forces interpret mode, for a
script whose kernel the test calls itself.  ``record_pallas(monkeypatch)``
wraps ``jax.experimental.pallas.pallas_call``
so that every call runs in interpret mode and each distinct kernel's first
call records its concrete inputs and outputs; the scripts' timing repeats
are served from that record.  A kernel is told apart by its code and the
scalars it and its nested functions close over (the scripts build their
variants as closures: ``make_kernel(sub, lanes, noload)``, ``mode``...).
Scripts whose ``main`` jits the call run under ``jax.disable_jit()`` so
the wrapper sees concrete arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from jax.experimental import pallas as pl


@dataclasses.dataclass
class Record:
    kernel: object
    consts: dict        # closure scalars by name, nested functions included
    inputs: list        # numpy arrays
    outputs: object     # what the kernel returned (JAX arrays)


def _consts(fn, seen=None) -> dict:
    seen = set() if seen is None else seen
    if id(fn) in seen or not hasattr(fn, "__code__"):
        return {}
    seen.add(id(fn))
    out = {}
    for name, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        try:
            v = cell.cell_contents
        except ValueError:
            continue
        if isinstance(v, (bool, int, float, str)):
            out[name] = v
        elif callable(v):
            out.update(_consts(v, seen))
    return out


def interpret_pallas(monkeypatch) -> None:
    real = pl.pallas_call

    def fake(kernel, *a, **kw):
        return real(kernel, *a, **{**kw, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", fake)


def record_pallas(monkeypatch) -> list[Record]:
    """Patch ``pl.pallas_call`` for the rest of the monkeypatch's scope;
    returns the list the records are appended to, in call order."""
    real = pl.pallas_call
    records: list[Record] = []
    by_key: dict = {}

    def fake(kernel, *a, **kw):
        kw["interpret"] = True
        inner = real(kernel, *a, **kw)

        def call(*args):
            consts = _consts(kernel)
            key = (kernel.__code__, tuple(sorted(consts.items())),
                   tuple(np.shape(x) for x in args))
            if key not in by_key:
                out = inner(*args)
                rec = Record(kernel, consts, [np.asarray(x) for x in args],
                             out)
                by_key[key] = rec
                records.append(rec)
            return by_key[key].outputs

        return call

    monkeypatch.setattr(pl, "pallas_call", fake)
    return records
