"""test_torch_step_bf16.py's whole-step comparison in the exact Thomas
form: one ``fused_bf16`` step of the port against cmcfs_tpu's (interpret
mode), the same fixture and bounds (measured below)."""
from test_torch_step_bf16 import step_matches


def test_fused_bf16_exact_step_matches_jax():
    step_matches("fused_bf16", True)
