"""Build the port's CUDA kernels with nvcc on first use and bind them.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a``, one nvcc process
per source, all started together; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
goes to ``build/cmcfs_tpu_torch/`` at the repository root (git-ignored),
named by a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so an edited source is never served by a stale library.
Nothing is compiled at import time: the first ``load_library()`` call
builds.  Each kernel wrapper counts its launches in a ``LaunchCounter``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BUILD_DIR = os.path.join(ROOT, "build", "cmcfs_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the library's entry points (argtypes, restype)
SIGNATURES = {
    "cmcfs_pair_sweep_iter": ([_P] * 10 + [_I] * 6 + [_F] * 8 + [_P], _I),
    "cmcfs_pcr_sweep_iter": ([_P] * 9 + [_I] * 6 + [_F] * 8 + [_P], _I),
    "cmcfs_stream_sweep_iter": ([_P] * 10 + [_I] * 8 + [_F] * 5 + [_P], _I),
    "cmcfs_line_sweep": ([_P] * 5 + [_I] * 7 + [_F] * 4 + [_P], _I),
    # the dual-free fallback iteration on the line sweep's walk
    "cmcfs_line_fallback": ([_P] * 12 + [_I] * 5 + [_F] * 9 + [_P], _I),
    # the bf16 payload mode: the pair entries take op_bf16, out_bf16 last
    "cmcfs_pair_sweep_iter_bf16": ([_P] * 10 + [_I] * 6 + [_F] * 8
                                   + [_I] * 2 + [_P], _I),
    "cmcfs_pcr_sweep_iter_bf16": ([_P] * 9 + [_I] * 6 + [_F] * 8 + [_I] * 2
                                  + [_P], _I),
    # a PCR instantiation's registers, local memory, blocks an SM, shared
    "cmcfs_pcr_sweep_info": ([_I] * 4 + [_P], _I),
    "cmcfs_pcr_sweep_info_bf16": ([_I] * 6 + [_P], _I),
    "cmcfs_stream_sweep_iter_bf16": ([_P] * 10 + [_I] * 8 + [_F] * 5 + [_P],
                                     _I),
    "cmcfs_line_sweep_bf16": ([_P] * 5 + [_I] * 7 + [_F] * 4 + [_P], _I),
    "cmcfs_tridiag_rows": ([_P] * 6 + [_L, _I, _L, _I, _I, _I, _P], _I),
    # the wavefront's carry Thomas passes: n, n1, s1, n2, sp, off, then
    # the systems' strides, k (and last, exact forward)
    "cmcfs_tridiag_carry_fwd": ([_P] * 10 + [_I, _I, _L, _I, _L, _L, _L, _L,
                                             _I, _I, _I, _P], _I),
    "cmcfs_tridiag_carry_bwd": ([_P] * 5 + [_I, _I, _L, _I, _L, _L, _L, _I,
                                            _P], _I),
    # the measurement probes (cmcfs_tpu_torch/probes)
    "cmcfs_probe_rowcost": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "cmcfs_probe_ilp": ([_P] * 4 + [_I] * 5 + [_P], _I),
    "cmcfs_probe_slabdma": ([_P] * 2 + [_I] * 3 + [_P], _I),
    "cmcfs_probe_lines": ([_P] * 2 + [_I, _L, _I, _P], _I),
    "cmcfs_kernel_probe": ([_P] * 7 + [_I] * 2 + [_P], _I),
    "cmcfs_probe_diss": ([_P] * 4 + [_I] * 3 + [_F] * 3 + [_I, _P], _I),
}


class LaunchCounter:
    """Kernel launches made by one wrapper on CUDA tensors.  ``chip_smoke.py``
    resets it before driving the main path and reads it after, to show the
    path went through the kernel."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float     # 0.0 when an up-to-date library was reused
    nvcc_log: str            # ptxas register/spill report of the build


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first failure.  Returns
    their output, each command's under a line naming its last argument."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(f"== nvcc {os.path.basename(cmd[-1])}\n{log}"
                   for cmd, log in zip(cmds, logs))


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    srcs = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"libcmcfs_kernels_{_digest(srcs)}.so")
    log = ""
    seconds = 0.0
    if not os.path.exists(path):
        nvcc = nvcc_path()
        tag = f"{os.getpid()}.tmp"
        objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{tag}.o")
                for s in srcs]
        t0 = time.perf_counter()
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                    for s, o in zip(srcs, objs)])
        tmp = f"{path}.{tag}"
        log += _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
        for o in objs:
            os.remove(o)
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds,
                         nvcc_log=log)
