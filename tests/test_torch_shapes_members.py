"""The member axis of tests/test_torch_shapes.py: the port's plain fused
SDF-FFN route past the resident CUDA kernels (widths above 128, 9 and 16
layers) at S = 3 against the JAX Pallas kernel vmapped over the members
(``interpret=True``), its jax.grad and summed panel cotangent. A file of its
own so the test workers share the interpreter's time. Tolerances: those of
tests/test_torch_ffn.py (see tests/test_torch_shapes.py)."""

import pytest

from test_torch_shapes import STACK_IDS, STACKS, check_plain_ffn_against_jax


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", STACKS, ids=STACK_IDS)
def test_plain_ffn_member_axis_matches_jax_vmap(hidden, cd):
    check_plain_ffn_against_jax(hidden, cd, 3)
