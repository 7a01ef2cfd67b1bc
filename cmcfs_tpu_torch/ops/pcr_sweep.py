"""The PCR pair sweep: the pair sweep with cyclic reduction for Thomas.

Port of the pcr mode of ``cmcfs_tpu/ops/pallas_sweep_nl.py::fused_sweep_nl``
(``_pcr_chain``, ``pcr_solve_all`` and the ``if pcr:`` branches of the
kernel body, pallas_sweep_nl.py:538-660, 758-1012), which backend
``fused_pcr`` runs on every ``pair`` direction.  Two local iterations of
one direction, 4 variables, with and without duals: the rows, RHS and
in-kernel dissipation of ``ops/pair_sweep.py``; PCR (``ops/pcr.py``) of
the velocities' shared (a, b, c) chain carrying u, v and w, then of T's
chain; with ``flags``, pass B's chains on the same d's, stitched under the
take bit; UpdateSegment, the NODE_IN merge and the gmerge fold.

``pcr_sweep`` dispatches on the tensors' device: CUDA tensors launch
``kernels/csrc/pcr_sweep.cu`` once per local iteration (lines of at most
``MAX_N`` cells, each reduced by one warp in registers) or raise; CPU tensors
run ``pcr_sweep_ref``, the plain version (``pair_sweep.pair_sweep_ref``
with ``pcr``), which the kernel equals bit for bit on the card.  bf16
payloads (backend ``fused_pcr_bf16``) are the pair sweep's bf16 mode:
``pcr_sweep_bf16.cu``'s entry, the first launch writing float32, the
second bfloat16.
"""
from __future__ import annotations

import torch

from ..kernels.build import LaunchCounter
from .pair_sweep import check_inputs, pair_sweep_ref

launches = LaunchCounter()     # one per local iteration
bf16_launches = LaunchCounter()   # the same, bf16 payloads
# the longest line a warp of the kernel holds (8 cells a lane): the pair
# kernel's line cap (pallas_sweep_nl.py:70), which the dispatch keeps
MAX_N = 256


def pcr_sweep(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis: int,
              exact: bool, gmerge: bool, flags=None):
    """Two local iterations of direction ``axis``; returns (out4, tn4).
    Arguments and payload dtypes as ``pair_sweep.pair_sweep``."""
    s = check_inputs(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis,
                     flags=flags)
    if temp4.device.type == "cpu":
        return pcr_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, s, axis,
                             exact, gmerge, flags)
    if temp4.device.type != "cuda":
        raise RuntimeError(f"pcr_sweep has no kernel for {temp4.device}")
    if cls.shape[axis] > MAX_N:
        raise ValueError(f"pcr_sweep takes lines of at most {MAX_N} cells, "
                         f"got {cls.shape[axis]}")
    counter = bf16_launches if rhs4.dtype == torch.bfloat16 else launches
    out1, tn1 = _launch(temp4, cls, bcv, bct, rhs4, out_prev4, flags, s,
                        axis, exact, False, torch.float32)
    counter.count += 1
    out4, tn4 = _launch(tn1, cls, bcv, bct, rhs4, out1, flags, s, axis,
                        exact, gmerge, rhs4.dtype)
    counter.count += 1
    return out4, tn4


def _launch(temp4, cls, bcv, bct, rhs4, op4, flags, s, axis, exact, gmerge,
            out_dtype):
    """One launch of ``pcr_sweep.cu``: one local iteration, out and tn of
    ``out_dtype``; a bfloat16 ``rhs4`` takes the bf16 entry."""
    from ..kernels.build import load_library
    lib = load_library().lib
    bf16 = rhs4.dtype == torch.bfloat16
    out4 = torch.empty_like(temp4, dtype=out_dtype)
    tn4 = torch.empty_like(temp4, dtype=out_dtype)
    nx, ny, nz = cls.shape
    pay = ((int(op4.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16)) if bf16 else ())
    fn = lib.cmcfs_pcr_sweep_iter_bf16 if bf16 else lib.cmcfs_pcr_sweep_iter
    with torch.cuda.device(temp4.device):
        stream = torch.cuda.current_stream(temp4.device).cuda_stream
        err = fn(temp4.data_ptr(), cls.data_ptr(), bcv.data_ptr(),
                 bct.data_ptr(), rhs4.data_ptr(), op4.data_ptr(),
                 None if flags is None else flags.data_ptr(),
                 out4.data_ptr(), tn4.data_ptr(), nx, ny, nz, axis,
                 int(exact), int(gmerge), *(float(x) for x in s), *pay,
                 stream)
    if err != 0:
        raise RuntimeError(f"pcr_sweep kernel launch failed: CUDA error {err} "
                           f"(shape {tuple(cls.shape)}, axis {axis})")
    return out4, tn4


# the payload types of the kernel's instantiations: (op_bf16, out_bf16) of
# the bf16 entry, None for the float32 one
PAYLOADS = {"f32": None, "bf16_in": (1, 0), "bf16_out": (0, 1)}


def kernel_info(n: int, axis: int, exact: bool, dual: bool,
                payload: str = "f32") -> dict:
    """What the card reports of one instantiation on lines of n cells:
    registers a thread, local memory a thread (bytes; 0 when nothing
    spills), blocks an SM and dynamic shared memory (bytes)."""
    import ctypes

    from ..kernels.build import load_library
    lib = load_library().lib
    out = (ctypes.c_int * 4)()
    pay = PAYLOADS[payload]
    if pay is None:
        err = lib.cmcfs_pcr_sweep_info(n, axis, int(exact), int(dual), out)
    else:
        err = lib.cmcfs_pcr_sweep_info_bf16(n, axis, int(exact), int(dual),
                                            *pay, out)
    if err != 0:
        raise RuntimeError(f"pcr_sweep kernel_info failed: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm",
                     "smem_bytes"), out))


def pcr_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis: int,
                  exact: bool, gmerge: bool, flags=None):
    """Plain PyTorch PCR pair sweep on any device; returns (out4, tn4)."""
    return pair_sweep_ref(temp4, cls, bcv, bct, rhs4, out_prev4, scal, axis,
                          exact, gmerge, flags, pcr=True)
