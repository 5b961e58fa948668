"""The generator-step parity of tests/test_torch_gan_step.py in float64 on
both sides, for a consistency arch (scp) and a plain one (cmgan): without
fp32's rounding, every gradient leaf is held to relative RMS < 1e-4.  The
bounds and the reasons for them are that file's.
"""

import numpy as np
import pytest
from test_torch_gan_step import check_generator_step
from torch_train_common import no_flax_dropout  # noqa: F401 (fixture)


@pytest.mark.parametrize("arch", ["scp", "cmgan"])
def test_float64_generator_step_matches_jax(no_flax_dropout, arch):  # noqa: F811
    check_generator_step(arch, fused=False, dtype=np.float64)
