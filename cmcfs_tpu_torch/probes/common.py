"""What the five probes share: the device and the card's name, a kernel
launch through the built library, timing, and one checked and timed row
per variant."""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import get_device

# the published H100 SXM peaks (NVIDIA's data sheet): device-memory rate,
# float32 outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# ~0.3 ms of spinning at the card's ~2 GHz clock (time_ms)
SPIN_CYCLES_PER_CALL = 600_000
# written before every cold call: five times the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
_flush_bufs: dict[torch.device, torch.Tensor] = {}


@dataclasses.dataclass
class Row:
    """One variant: its kernel checked against its plain version, timed."""
    variant: str
    ms: float               # one kernel call, L2 flushed: CUDA events
    plain_ms: float         # one plain PyTorch call, on the same inputs
    err: float              # max |kernel - plain|
    tol: float              # the bound err must hold; 0 is bit for bit
    nbytes: float           # compulsory bytes: inputs read, outputs written
    flops: float = 0.0      # float32 operations of one call
    note: str = ""
    library_ms: float | None = None
    call_ms: float | None = None   # host wall time of one call (host_ms)
    hot_ms: float | None = None    # back to back on the same inputs

    @property
    def ok(self) -> bool:
        return self.err <= self.tol

    @property
    def bound_by(self) -> str:
        return ("bytes" if self.nbytes / HBM_BYTES_S >= self.flops / F32_FLOP_S
                else "operations")

    @property
    def bound_ms(self) -> float:
        """The least time the card could take: bytes over the memory rate
        or operations over the float32 rate, whichever is larger."""
        return max(self.nbytes / HBM_BYTES_S, self.flops / F32_FLOP_S) * 1e3


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)


def device_and_generator(args) -> tuple[torch.device, torch.Generator]:
    dev = get_device(args.device)
    return dev, torch.Generator(device=dev).manual_seed(args.seed)


def uniform(shape, lo: float, hi: float, gen: torch.Generator,
            dev: torch.device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo


def as_f32(x) -> torch.Tensor:
    """A numpy array (the JAX scripts' inputs) or a tensor, as a contiguous
    float32 tensor on its device (numpy on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).contiguous()
    return torch.from_numpy(np.require(x, np.float32, ["C", "W"]))


def check_tensors(what: str, *ts: torch.Tensor) -> torch.device:
    """Raise unless every tensor is float32, contiguous and on one device;
    returns that device."""
    dev = ts[0].device
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous float32, "
                             f"got {t.dtype}, contiguous={t.is_contiguous()}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} has no kernel for {dev}")
    return dev


def launch(name: str, dev: torch.device, *args) -> None:
    """Call the library's entry ``name`` on the current stream of ``dev``
    (the stream is its last argument); raise on a non-zero CUDA error."""
    from ..kernels.build import load_library
    fn = getattr(load_library().lib, name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def card_line(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or what a CPU run
    is."""
    if dev.type != "cuda":
        return "cpu: the plain PyTorch versions, host-clock times"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0].strip()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flush_buf(dev: torch.device) -> torch.Tensor:
    if dev not in _flush_bufs:
        _flush_bufs[dev] = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                       device=dev)
    return _flush_bufs[dev]


def time_ms(fn, reps: int, dev: torch.device, cold: bool = True) -> float:
    """Mean time of one ``fn()`` over ``reps`` calls: CUDA events on the
    card, the host clock on the CPU.  The caller has warmed ``fn`` up.  On
    the card a spin kernel first holds the stream for ~0.3 ms a call, so
    the host has queued every call before the first event: the events
    time the kernels, not the Python that launches them, which can take
    longer than a small kernel (``host_ms``).  ``cold``: a 256 MB buffer
    is written before each call, so the call finds none of its inputs in
    L2, and an event pair times each call alone; otherwise the calls run
    back to back on the same inputs, L2-resident where they fit."""
    if dev.type == "cuda":
        n_ev = 2 * reps if cold else 2
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_ev)]
        torch.cuda._sleep(int(SPIN_CYCLES_PER_CALL * reps))
        if cold:
            buf = _flush_buf(dev)
            for i in range(reps):
                buf.zero_()
                ev[2 * i].record()
                fn()
                ev[2 * i + 1].record()
        else:
            ev[0].record()
            for _ in range(reps):
                fn()
            ev[1].record()
        torch.cuda.synchronize(dev)
        return sum(ev[i].elapsed_time(ev[i + 1])
                   for i in range(0, n_ev, 2)) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def host_ms(fn, reps: int, dev: torch.device) -> float:
    """Wall time of one ``fn()`` over ``reps`` calls, ended by a
    synchronize: the larger of the host's launch cost and the device's
    time."""
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _parts(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_err(got, want) -> float:
    """max |got - want| over the parts of a result; inf where either side
    is not finite."""
    err = 0.0
    for g, w in zip(_parts(got), _parts(want)):
        if not (bool(torch.isfinite(g).all()) and
                bool(torch.isfinite(w).all())):
            return float("inf")
        err = max(err, float((g - w).abs().max()))
    return err


def measure(variant: str, kernel, plain, reps: int, dev: torch.device,
            nbytes: float, rel_tol: float = 0.0, library=None,
            flops: float = 0.0) -> Row:
    """Check ``kernel()`` against ``plain()`` (max |delta| within
    rel_tol * max(1, max|plain|); rel_tol 0 asks for equality), then time
    both and, where one is given, the library call: each with L2 flushed
    before every call, and the kernel also back to back (``hot_ms``)."""
    got, want = kernel(), plain()
    sync(dev)
    err = max_abs_err(got, want)
    scale = max(max(1.0, float(w.abs().max())) for w in _parts(want))
    del got, want
    ms = time_ms(kernel, reps, dev)
    hot = time_ms(kernel, reps, dev, cold=False)
    call_ms = host_ms(kernel, reps, dev)
    plain_ms = time_ms(plain, 1, dev)
    lib_ms = None
    if library is not None:
        library()
        lib_ms = time_ms(library, reps, dev)
    return Row(variant, ms, plain_ms, err, rel_tol * scale, nbytes, flops,
               library_ms=lib_ms, call_ms=call_ms, hot_ms=hot)


def print_table(title: str, rows: list[Row], dev: torch.device,
                file=None) -> None:
    file = file or sys.stdout
    card = card_line(dev)
    print(f"{title}  [{card}]", file=file)
    print(f"  {'variant':<24}{'ms':>9}{'hot ms':>9}{'call ms':>9}"
          f"{'plain ms':>10}{'max|d|':>11}{'bound':>9}{'bound ms':>10}  note",
          file=file)
    for r in rows:
        tol = "bitwise" if r.tol == 0 else f"{r.tol:.1e}"
        lib = "" if r.library_ms is None else \
            f"; library {r.library_ms:.4f} ms"
        flag = "" if r.ok else "  MISMATCH"
        print(f"  {r.variant:<24}{r.ms:>9.4f}{r.hot_ms:>9.4f}"
              f"{r.call_ms:>9.4f}{r.plain_ms:>10.3f}{r.err:>11.3e}{tol:>9}"
              f"{r.bound_ms:>10.4f}  {r.note}{lib}{flag}", file=file)
    if dev.type == "cuda":
        print("  (ms: L2 flushed before each call; hot ms: back to back on "
              "the same inputs)", file=file)
    print(f"  ({card})", file=file, flush=True)
