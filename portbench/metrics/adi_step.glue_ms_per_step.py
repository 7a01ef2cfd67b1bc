"""Device milliseconds a traced step of every operation that is not one of
the port's own kernels (PyTorch's right-hand sides, folds, merges,
boundaries, the divergence error, copies), summed over the cards."""
# the port's kernels (cmcfs_tpu_torch/kernels/csrc/*.cu), as
# cmcfs_tpu_torch/profile3d.py names them
PORT_KERNELS = ("pair_sweep_iter_kernel", "line_sweep_kernel",
                "tridiag_rows_kernel", "pcr_sweep_iter_kernel",
                "carry_fwd_kernel", "carry_bwd_kernel")


def read(rec):
    t = rec.trace
    if t is None or not t.kernels:
        return None
    glue = sum(e - s for n, s, e, _ in t.kernels
               if not any(k + c in n for k in PORT_KERNELS for c in "(<"))
    return glue * 1e-3 / t.steps
