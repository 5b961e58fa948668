"""The middle of the conformers' conv module (``ops/fused_conv_module.py``:
GLU, zero pad, depthwise conv, eval BatchNorm, swish).

On the CPU, where the wrapper takes its plain version: that version equals
``ConvModule.after_norm``'s eager layers bit for bit (fp32 and bf16, u
channels-major and as rows, the model's k31 and a shorter kernel, a whole
and a partial channel group); the route runs the eager layers for each
condition the kernel does not take; ``TSCNet`` without autograd is
unchanged; the wrapper refuses operands it cannot take before any launch;
and the counters count only under a profiler session.

The cases marked ``card`` hold the kernel to the plain version on a CUDA
card and skip without one.  ``tests/conftest.py`` imports JAX, which the
card's machine lacks, so run them there without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_conv_module.py
"""

import pytest
import torch
from torch import nn

from speech_enhancement_tpu_torch.models import TSCNet, conformer
from speech_enhancement_tpu_torch.models.conformer import ConvModule
from speech_enhancement_tpu_torch.models.layers import BatchNorm1d
from speech_enhancement_tpu_torch.ops import _native
from speech_enhancement_tpu_torch.ops import fused_conv_module as fcm
from speech_enhancement_tpu_torch.utils import profiling

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def _module(dim: int, kernel_size: int = 31, seed: int = 0, dtype=torch.float32,
            device="cpu") -> ConvModule:
    """A ConvModule in eval mode, weights and statistics away from init."""
    torch.manual_seed(seed)
    m = ConvModule(dim, kernel_size=kernel_size).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        norm = m.net[5]
        norm.weight.copy_(1 + 0.5 * torch.randn(norm.num_features, generator=g))
        norm.bias.copy_(0.5 * torch.randn(norm.num_features, generator=g))
        norm.running_mean.copy_(0.5 * torch.randn(norm.num_features, generator=g))
        norm.running_var.copy_(0.5 + torch.rand(norm.num_features, generator=g))
    return m.to(device=device, dtype=dtype)


def _u(b: int, c2: int, n: int, layout: str, dtype=torch.float32, seed: int = 1,
       device="cpu") -> torch.Tensor:
    """A first pointwise conv's output: channels-major, or a channels-last
    product seen as ``[B, 2C, N]``."""
    g = torch.Generator().manual_seed(seed)
    if layout == "cols":
        u = torch.randn(b, c2, n, generator=g)
    else:
        u = torch.randn(b, n, c2, generator=g).transpose(1, 2)
    return u.to(device=device, dtype=dtype)


def _eager(m: ConvModule, u: torch.Tensor) -> torch.Tensor:
    """The module's own layers: GLU, DepthWiseConv1d (pad, conv), BatchNorm, Swish."""
    net = m.net
    return net[6](net[5](net[4](net[3](u))))


@pytest.mark.parametrize("dim, kernel_size", [(64, 31), (20, 3)])
@pytest.mark.parametrize("layout", ["cols", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_modules_middle(dtype, layout, dim, kernel_size):
    m = _module(dim, kernel_size, seed=dim, dtype=dtype)
    u = _u(3, 4 * dim, 37, layout, dtype)
    conv, norm = m.net[4].conv, m.net[5]
    want = _eager(m, u)
    launches = _native.launches["glu_conv_swish"]
    with torch.no_grad():
        got = fcm.glu_conv_swish(u, conv, norm)
    assert _native.launches["glu_conv_swish"] == launches  # the CPU takes the plain version
    assert got.dtype == dtype and got.shape == (3, 2 * dim, 37)
    assert torch.equal(got, want)
    assert torch.equal(fcm.glu_conv_swish_reference(u, conv, norm), want)


def test_u_layout_reads_the_pointwise_product_in_place():
    assert fcm.u_layout(_u(2, 8, 5, "cols")) == fcm.COLS
    assert fcm.u_layout(_u(2, 8, 5, "rows")) == fcm.ROWS
    assert fcm.u_layout(torch.randn(8, 2, 5).transpose(0, 1)) == -1
    assert fcm.u_layout(torch.randn(2, 8, 10)[..., ::2]) == -1


def _variant(case: str):
    """(module, u, reason expected, grad on) for one condition the kernel
    does not take; "cpu" takes every other."""
    dtype = torch.float64 if case == "float64" else torch.float32
    m = _module(16, 30 if case == "even" else 31, dtype=dtype)
    if case == "train":
        m.train()
    if case == "stats":
        m.net[5] = BatchNorm1d(32, eps=1e-5, track_running_stats=False).eval()
    u = _u(2, 64, 23, "rows", dtype)
    reason = {"grad": "autograd", "train": "training mode", "stats": "running statistics",
              "float64": "dtype", "even": "kernel size 30", "cpu": "a cpu tensor"}[case]
    return m, u, reason, case == "grad"


@pytest.mark.parametrize("case", ["grad", "train", "stats", "float64", "even", "cpu"])
def test_route_runs_the_eager_layers_where_the_kernel_does_not_go(case, monkeypatch):
    m, u, reason, grad = _variant(case)
    depthwise, norm = m.net[4], m.net[5]
    x = torch.randn(2, 23, 16, generator=torch.Generator().manual_seed(5)).to(u.dtype)
    with torch.set_grad_enabled(grad):
        why = fcm.eager_reason(u, depthwise.conv, depthwise.padding, norm)
        assert why is not None and reason in why
        taken = []
        monkeypatch.setattr(conformer, "glu_conv_swish",
                            lambda *a: taken.append(a) or fcm.glu_conv_swish(*a))
        state = {k: v.clone() for k, v in m.state_dict().items()}
        torch.manual_seed(6)
        got = m.after_norm(x)
        m.load_state_dict(state)  # a train-mode BatchNorm moved its statistics
        torch.manual_seed(6)
        want = m.net[9](m.net[8](m.net[7](_eager(m, m.net[2](m.net[1](x))))))
    assert taken == [] and torch.equal(got, want)
    if case == "train":
        assert not torch.equal(m.net[5].running_mean, state["net.5.running_mean"])


def test_tscnet_without_autograd_is_unchanged(monkeypatch):
    """Eight conv modules a forward ask the route, and on the CPU each runs
    its eager layers: the output equals the forward under autograd."""
    reasons = []

    def spy(u, conv, padding, norm):
        why = fcm.eager_reason(u, conv, padding, norm)
        reasons.append(why)
        return why

    monkeypatch.setattr(conformer, "eager_reason", spy)
    model = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(2)).eval()
    spec = torch.randn(2, 21, 201, dtype=torch.complex64,
                       generator=torch.Generator().manual_seed(3))
    want = model(spec)
    assert reasons == []
    with torch.no_grad():
        got = model(spec)
    assert reasons == ["a cpu tensor"] * 8
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _refusals():
    """(what, u, conv, norm, message) for a module of 32 GLU channels."""
    m = _module(16)
    conv, norm = m.net[4].conv, m.net[5]
    u = _u(2, 64, 9, "cols")
    stats = BatchNorm1d(32, track_running_stats=False).eval()
    return [
        ("u channels", u[:, :60], conv, norm, r"\[B, 64, N\]"),
        ("u rank", u[0], conv, norm, r"\[B, 64, N\]"),
        ("not depthwise", u, nn.Conv1d(32, 32, 31, groups=4), norm, "depthwise"),
        ("padded conv", u, nn.Conv1d(32, 32, 31, groups=32, padding=15), norm, "depthwise"),
        ("even", u, nn.Conv1d(32, 32, 30, groups=32), norm, "odd sizes"),
        ("long", u, nn.Conv1d(32, 32, 33, groups=32), norm, "odd sizes"),
        ("norm channels", u, conv, _module(8).net[5], "BatchNorm over 32"),
        ("no statistics", u, conv, stats, "running"),
        ("no conv bias", u, nn.Conv1d(32, 32, 31, groups=32, bias=False), norm, "bias"),
        ("no affine", u, conv, BatchNorm1d(32, affine=False).eval(), "affine"),
        ("dtype", u.bfloat16(), conv, norm, "bfloat16"),
        ("device", u.to("meta"), conv, norm, "meta"),
        ("meta", u.to("meta"), conv.to("meta"), _module(16).net[5].to("meta"), "CPU or CUDA"),
    ]


@pytest.mark.parametrize("case", range(13))
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    name, u, conv, norm, match = _refusals()[case]
    launches = _native.launches["glu_conv_swish"]
    with torch.no_grad(), pytest.raises(ValueError, match=match):
        fcm.glu_conv_swish(u, conv, norm)
    assert _native.launches["glu_conv_swish"] == launches, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counters_count_under_a_profiler_session_only(dtype):
    u = _u(3, 256, 50, "rows", dtype)
    launches = _native.launches["glu_conv_swish"]
    profiling.clear()
    fcm.count_launch(u)
    assert profiling.counts() == [] and _native.launches["glu_conv_swish"] == launches + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fcm.count_launch(u)
        got = [(c.name, c.n) for c in profiling.counts()]
    profiling.clear()
    # u read once (3 x 256 x 50), its half written once
    assert got == [("convmod.launches", 1), ("convmod.bytes", 3 * 384 * 50 * u.element_size())]
    assert _native.launches["glu_conv_swish"] == launches + 2


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    return torch.device("cuda")


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).pow(2).mean() / want.pow(2).mean()).sqrt())


# fp32: BatchNorm's arithmetic and the sum's order; bf16: an intermediate's
# rounding may flip
TOLS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.card
@pytest.mark.parametrize("n", [7, 15, 16, 100, 128, 129, 143, 300])
@pytest.mark.parametrize("layout", ["cols", "rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_the_plain_version(cuda, dtype, layout, n):
    """N below, at and above a tile (128 frames) and a halo (15)."""
    m = _module(64, dtype=dtype, device=cuda)
    conv, norm = m.net[4].conv, m.net[5]
    u = _u(5, 256, n, layout, dtype, seed=n, device=cuda)
    launches = _native.launches["glu_conv_swish"]
    with torch.no_grad():
        got = fcm.glu_conv_swish(u, conv, norm)
        want = fcm.glu_conv_swish_reference(u, conv, norm)
    torch.cuda.synchronize()
    assert _native.launches["glu_conv_swish"] == launches + 1
    assert got.dtype == dtype and got.shape == (5, 128, n) and got.is_contiguous()
    assert _rel_rms(got, want) <= TOLS[dtype]


@pytest.mark.card
@pytest.mark.parametrize("dim, kernel_size", [(20, 3), (48, 15), (40, 31)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_partial_groups_and_shorter_kernels(cuda, dtype, dim, kernel_size):
    m = _module(dim, kernel_size, dtype=dtype, device=cuda)
    u = _u(3, 4 * dim, 131, "rows", dtype, device=cuda)
    with torch.no_grad():
        got = fcm.glu_conv_swish(u, m.net[4].conv, m.net[5])
        want = fcm.glu_conv_swish_reference(u, m.net[4].conv, m.net[5])
    assert _rel_rms(got, want) <= TOLS[dtype]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_module_takes_the_kernel_without_autograd(cuda, dtype):
    m = _module(64, dtype=dtype, device=cuda)
    x = torch.randn(4, 301, 64, device=cuda).to(dtype)
    want = m(x)  # autograd on: the eager layers
    launches = _native.launches["glu_conv_swish"]
    with torch.no_grad():
        got = m.after_norm(m.net[0](x))
    assert _native.launches["glu_conv_swish"] == launches + 1
    assert _rel_rms(got, want) <= TOLS[dtype]
