"""The TPU measurement probes as hand-written H100 probes.

One module per script of ``scripts/`` that reaches ``pl.pallas_call``
outside the solver, named after it: ``probe_rowcost`` (serial row-step
cost), ``probe_ilp`` (interleaved chains), ``probe_slabdma`` (slab copy
rate and lines along the contiguous axis), ``kernel_probe`` (copy floor,
compute floor and the real solve) and ``probe_diss_bitwise`` (in-kernel
dissipation, bit for bit).  Each has a CUDA kernel under
``kernels/csrc/``, a wrapper that counts its launches, its plain PyTorch
version, a ``run(args)`` that checks every variant's kernel against the
plain version and times both, and a ``main(argv)`` with the script's flags.

    python -m cmcfs_tpu_torch.probes [--only NAME] [--device cuda|cpu]
        [--reps R]
"""
from . import (kernel_probe, probe_diss_bitwise, probe_ilp, probe_rowcost,
               probe_slabdma)

# in the order they are run
PROBES = {
    "probe_rowcost": probe_rowcost,
    "probe_ilp": probe_ilp,
    "probe_slabdma": probe_slabdma,
    "kernel_probe": kernel_probe,
    "probe_diss_bitwise": probe_diss_bitwise,
}
