"""test_torch_step_bf16.py's whole-step comparison for ``fused_pcr_bf16``:
every direction on the bf16 PCR pair, one step of the port against
cmcfs_tpu's (interpret mode), reciprocal form, the same fixture and
bounds (measured below)."""
from test_torch_step_bf16 import step_matches


def test_fused_pcr_bf16_step_matches_jax():
    step_matches("fused_pcr_bf16", False)
