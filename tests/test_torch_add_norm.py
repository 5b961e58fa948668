"""The residual add and LayerNorm of the conformers' inference forward
(``ops/fused_norm.py``) on the CPU, where the wrapper takes its plain
version: that version equals the conformer's eager op sequence bit for bit
(fp32 and bf16, row-major and channels-major y, with and without skip, at
the C the models build and two others); ``ConformerBlock`` and ``TSCNet``
without autograd equal their forward under autograd; the block makes five
calls, the last with the outer residual; and the wrapper refuses operands
that disagree before any launch.

The kernel itself runs only on a card: ``chip_smoke.py`` holds it to this
plain version there.
"""

import pytest
import torch
from torch import nn

from speech_enhancement_tpu_torch.models import ConformerBlock, TSCNet
from speech_enhancement_tpu_torch.models import conformer
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops import fused_norm as fn

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def _norm(c: int, dtype: torch.dtype, seed: int) -> nn.LayerNorm:
    """A LayerNorm with weights away from their init."""
    norm = nn.LayerNorm(c, eps=conformer.LN_EPS)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.5 * torch.randn(c, generator=g))
        norm.bias.copy_(0.5 * torch.randn(c, generator=g))
    return norm.to(dtype)


def _operands(c, dtype, layout, seed, b=3, n=37):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, c, generator=g).to(dtype)
    if layout == "rows":
        y = torch.randn(b, n, c, generator=g).to(dtype)
    else:  # a conv module's [B, C, N] output through its transpose
        y = torch.randn(b, c, n, generator=g).to(dtype).transpose(1, 2)
    skip = torch.randn(b, n, c, generator=g).to(dtype)
    return x, y, skip


def _eager(x, y, scale, norm, skip):
    """The conformer's ops as the block runs them under autograd: the
    feed-forwards' ``Scale`` multiplies, the residual adds, the LayerNorm
    module, the TSCB's outer add."""
    r = (y * scale if scale != 1 else y) + x
    n = norm(r)
    return r, (n if skip is None else n + skip)


@pytest.mark.parametrize("c", [64, 96, 30])
@pytest.mark.parametrize("scale", [0.5, 1.0])
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("layout", ["rows", "cols"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_eager_sequence(dtype, layout, with_skip, scale, c):
    x, y, skip = _operands(c, dtype, layout, seed=c + int(4 * scale))
    skip = skip if with_skip else None
    norm = _norm(c, dtype, seed=c)
    want_r, want_n = _eager(x, y, scale, norm, skip)
    launches = dict(_native.launches)
    r, n = fn.add_layer_norm(x, y, scale, norm, skip)
    assert _native.launches == launches  # the CPU takes the plain version
    assert torch.equal(r, want_r) and torch.equal(n, want_n)
    assert r.dtype == n.dtype == dtype
    ref_r, ref_n = fn.add_layer_norm_reference(x, y, scale, norm, skip)
    assert torch.equal(ref_r, want_r) and torch.equal(ref_n, want_n)
    r, n = fn.add_layer_norm(x, y, scale, norm, skip, keep_sum=False)
    assert r is None and torch.equal(n, want_n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_without_y_it_is_the_norm(dtype):
    x, _, skip = _operands(64, dtype, "rows", seed=5)
    norm = _norm(64, dtype, seed=6)
    r, n = fn.add_layer_norm(x, None, 1.0, norm)
    assert r is x and torch.equal(n, norm(x))
    r, n = fn.add_layer_norm(x, None, 1.0, norm, skip, keep_sum=False)
    assert r is None and torch.equal(n, norm(x) + skip)


def test_y_layout_reads_the_conv_residual_in_place():
    """The conv module's output reaches the add as a channels-major view,
    which the kernel reads from its strides (no copy); a contiguous y is
    row-major; any other view is copied by the wrapper."""
    block = ConformerBlock(16, dim_head=4, heads=4).eval()
    x = torch.randn(2, 23, 16)
    with torch.no_grad():
        y = block.conv.after_norm(block.conv.net[0](x))
        assert y.shape == x.shape and not y.is_contiguous()
        assert fn.y_layout(y) == fn.COLS
        assert torch.equal(block.conv(x), y)
    assert fn.y_layout(x) == fn.ROWS
    assert fn.y_layout(torch.randn(23, 2, 16).transpose(0, 1)) == -1
    assert fn.y_layout(torch.randn(4, 2, 23, 16).transpose(2, 3)) == -1


def _conformer_input(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(3, 21, 16, generator=g).to(dtype),
            torch.randn(3, 21, 16, generator=g).to(dtype))


@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conformer_without_autograd_equals_its_autograd_forward(dtype, with_skip):
    torch.manual_seed(0)
    block = ConformerBlock(16, dim_head=4, heads=4).eval().to(dtype)
    x, skip = _conformer_input(dtype)
    skip = skip if with_skip else None
    want = block(x, skip)
    with torch.no_grad():
        got = block(x, skip)
    with torch.inference_mode():
        got_inference = block(x, skip)
    assert torch.equal(got, want) and torch.equal(got_inference, want)
    if skip is not None:
        assert torch.equal(want, block(x) + skip)


@pytest.mark.parametrize("train", [False, True])
def test_tscnet_without_autograd_equals_its_autograd_forward(train):
    """Eval, and train mode (dropout 0.2 in the conformers) with the same
    seed: the batch statistics and the dropout masks come out the same."""
    model = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(2))
    model.train(train)
    spec = torch.randn(2, 21, 201, dtype=torch.complex64,
                       generator=torch.Generator().manual_seed(3))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    torch.manual_seed(4)
    want = model(spec)
    model.load_state_dict(state)
    torch.manual_seed(4)
    with torch.no_grad():
        got = model(spec)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_conformer_route_makes_five_calls(monkeypatch):
    """Five add-and-norm calls a block without autograd (the first without
    y, the last with the TSCB's residual and no sum kept), none under
    autograd; a TSCNet forward makes 40."""
    calls = []

    def spy(x, y, scale, norm, skip=None, keep_sum=True):
        calls.append((y is None, scale, skip is not None, keep_sum))
        return fn.add_layer_norm(x, y, scale, norm, skip, keep_sum)

    monkeypatch.setattr(conformer, "add_layer_norm", spy)
    block = ConformerBlock(16, dim_head=4, heads=4).eval()
    x, skip = _conformer_input(torch.float32)
    block(x, skip)
    assert calls == []
    with torch.no_grad():
        block(x, skip)
    assert calls == [(True, 1.0, False, True), (False, 0.5, False, True),
                     (False, 1.0, False, True), (False, 1.0, False, True),
                     (False, 0.5, True, False)]
    # a strided input that is also the outer residual (a TSCB at batch 1)
    # is copied once, for both
    calls.clear()
    seen = []
    monkeypatch.setattr(conformer, "add_layer_norm",
                        lambda x, y, scale, norm, skip=None, keep_sum=True:
                        seen.append((x, skip)) or fn.add_layer_norm(x, y, scale, norm, skip,
                                                                    keep_sum))
    strided = torch.randn(16, 21, 3).permute(2, 1, 0)
    with torch.no_grad():
        got = block(strided, strided)
    assert seen[0][0].is_contiguous() and seen[-1][1] is seen[0][0]
    assert torch.equal(got, block(strided, strided))
    monkeypatch.setattr(conformer, "add_layer_norm", spy)
    model = TSCNet(8, 201, device="cpu").eval()
    with torch.no_grad():
        model(torch.randn(1, 9, 201, dtype=torch.complex64))
    assert len(calls) == 40 and sum(skip for _, _, skip, _ in calls) == 8


def test_wrapper_refuses_operands_that_disagree():
    x, y, skip = _operands(64, torch.float32, "rows", seed=7)
    norm = _norm(64, torch.float32, seed=8)
    with pytest.raises(ValueError, match="channels"):
        fn.add_layer_norm(x, y, 0.5, _norm(32, torch.float32, seed=8))
    with pytest.raises(ValueError, match="shape"):
        fn.add_layer_norm(x, y[..., :32], 0.5, norm)
    with pytest.raises(ValueError, match="shape"):
        fn.add_layer_norm(x, y, 0.5, norm, skip[:, :5])
    with pytest.raises(ValueError, match="bfloat16"):
        fn.add_layer_norm(x, y.bfloat16(), 0.5, norm)
    with pytest.raises(ValueError, match="bfloat16"):
        fn.add_layer_norm(x, y, 0.5, _norm(64, torch.bfloat16, seed=8))
    with pytest.raises(ValueError, match="meta"):
        fn.add_layer_norm(x, y.to("meta"), 0.5, norm)
    with pytest.raises(ValueError, match="meta"):
        fn.add_layer_norm(x, y, 0.5, norm, skip.to("meta"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fn.add_layer_norm(x.to("meta"), y.to("meta"), 0.5, norm.to("meta"))
