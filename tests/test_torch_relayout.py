"""The plain version of the K6 axis swap against the JAX swap_seq_axes
(Pallas, interpret mode on the CPU), forward and VJP, with ragged F and
T; TSCNet(fused_relayout=True) against fused_relayout=False; and the
wrapper's checks, which refuse what the kernel cannot take before any
launch.

A swap is a copy: the comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.ops.pallas_relayout import swap_seq_axes as jax_swap
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops import fused_relayout as fr

# one intra-op thread: the pytest-xdist workers share the cores, and with
# torch's default of a thread per core in each, these tests took 3.5x as long
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(2, 7, 11, 8), (1, 105, 130, 4)])
def test_swap_matches_jax_forward_and_vjp(shape):
    """(1, 105, 130, 4) is ragged against the JAX kernel's default tiles
    (104 x 128)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    gy = rng.standard_normal((shape[0], shape[2], shape[1], shape[3])).astype(np.float32)
    want, vjp = jax.vjp(jax_swap, jnp.asarray(x))
    (want_gx,) = vjp(jnp.asarray(gy))

    xt = torch.from_numpy(x).requires_grad_()
    launches = dict(_native.launches)
    got = fr.swap_seq_axes(xt)
    got.backward(torch.from_numpy(gy))
    assert _native.launches == launches  # the CPU takes the plain version
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_gx))
    assert torch.equal(fr.swap_seq_axes_reference(xt.detach()), got.detach())


def test_tscnet_fused_relayout_equals_plain_fold():
    """Same weights, both flags, forward and every parameter gradient."""
    spec = torch.randn(2, 21, 201, dtype=torch.complex64,
                       generator=torch.Generator().manual_seed(0))
    outs = {}
    for fused in (False, True):
        model = TSCNet(8, 201, fused_relayout=fused, device="cpu",
                       generator=torch.Generator().manual_seed(1))
        model.eval()
        re, im = model(spec)
        grads = torch.autograd.grad((re ** 2).mean() + (im ** 2).mean(),
                                    list(model.parameters()))
        outs[fused] = (re, im, grads)
    for a, b in zip(outs[False][:2], outs[True][:2]):
        assert torch.equal(a, b)
    for a, b in zip(outs[False][2], outs[True][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 4), torch.float32),           # not 4-D
    ((2, 3, 4, 8), torch.float16),        # not a kernel dtype
    ((2, 3, 4, 8), torch.int32),
    ((65536, 1, 1, 8), torch.bfloat16),   # batch past the grid
])
def test_swap_checks_raise_before_launch(shape, dtype):
    with pytest.raises(ValueError):
        fr._check(torch.empty(shape, dtype=dtype))


def test_swap_check_passes_model_shapes():
    for dtype in (torch.float32, torch.bfloat16):
        fr._check(torch.empty((8, 101, 161, 64), dtype=dtype))
