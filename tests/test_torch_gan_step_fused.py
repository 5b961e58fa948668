"""The generator-step parity of tests/test_torch_gan_step.py with
``fused_attention=True`` on both sides: the Pallas forward and backward
kernels (interpret mode) in JAX, the autograd route with the plain
versions of K1 and K2 in the port.  The bounds and the reasons for them
are that file's.
"""

import pytest
from test_torch_gan_step import check_generator_step
from torch_train_common import no_flax_dropout  # noqa: F401 (fixture)


@pytest.mark.parametrize("arch", ["scp", "cp", "sc", "cmgan"])
def test_fused_generator_step_matches_jax(no_flax_dropout, arch):  # noqa: F811
    check_generator_step(arch, fused=True)
