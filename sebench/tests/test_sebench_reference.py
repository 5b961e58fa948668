"""The plain reference against the port's plain path at a tiny width on the
CPU, the FLOP counter by hand, and the import rules."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import torch

from sebench import harness, weights
from sebench.reference import dsp, flops
from sebench.reference import models as ref
from sebench.reference import train as ref_train

PORT = "speech_enhancement_tpu_torch"
JAX_SIDE = {"jax", "jaxlib", "flax", "speech_enhancement_tpu"}


def _pair(width=8):
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet

    state = weights.seeded_state(ref.TSCNet(width, 201), 3, torch.device("cpu"))
    dstate = weights.seeded_state(ref.Discriminator(4), 4, torch.device("cpu"))
    gen, disc = TSCNet(width, 201, device="cpu"), Discriminator(4, device="cpu")
    gen.load_state_dict(state)
    disc.load_state_dict(dstate)
    rgen, rdisc = ref.TSCNet(width, 201), ref.Discriminator(4)
    rgen.load_state_dict(state)
    rdisc.load_state_dict(dstate)
    return gen, disc, rgen, rdisc


def test_featurization_matches_the_port():
    port = importlib.import_module("speech_enhancement_tpu_torch.ops.stft")

    x = torch.randn(2, 4000, dtype=torch.float64)
    re, im = dsp.compressed_stft(x, 400, 100, 0.3)
    spec = port.compressed_stft(x, 400, 100, comp_type="pow")
    assert torch.allclose(re, spec.real, atol=1e-12) and torch.allclose(im, spec.imag, atol=1e-12)
    back = dsp.uncompressed_istft(re, im, 400, 100, 0.3, 4000)
    assert torch.allclose(back, port.uncompressed_istft(spec, 400, 100, length=4000), atol=1e-12)
    assert torch.allclose(dsp.rms_gain(x), port.normalize_batch(x, x)[2])


def test_models_match_the_port_forward_and_train_gradients():
    gen, disc, rgen, rdisc = _pair()
    spec = torch.randn(2, 41, 201, dtype=torch.complex64)
    gen.eval()
    rgen.eval()
    with torch.no_grad():
        a, b = gen(spec), rgen(spec.real, spec.imag)
    assert max((x - y).abs().max().item() for x, y in zip(a, b)) < 1e-4
    # training: the same dropout masks under one seed, the same gradients
    gen.train()
    rgen.train()
    disc.train()
    rdisc.train()
    grads = []
    for g, d, call in ((gen, disc, lambda: gen(spec)), (rgen, rdisc, lambda: rgen(spec.real, spec.imag))):
        torch.manual_seed(11)
        re, im = call()
        mag = torch.sqrt(re ** 2 + im ** 2)
        loss = re.square().mean() + d(mag, mag).mean()
        grads.append(dict(zip([n for n, _ in g.named_parameters()],
                              torch.autograd.grad(loss, list(g.parameters())))))
    for name, want in grads[1].items():
        assert torch.allclose(grads[0][name], want, rtol=1e-3, atol=1e-6), name


def test_flop_count_of_a_conv_and_a_linear_by_hand():
    conv = torch.nn.Conv2d(3, 5, (2, 3), device="meta")
    x = torch.empty(2, 3, 7, 11, device="meta")
    # output 2 x 5 x 6 x 9, each a 3 x 2 x 3 dot product: 2 FLOPs a term
    assert flops._count(lambda: conv(x)) == 2 * (2 * 5 * 6 * 9) * (3 * 2 * 3)
    lin = torch.nn.Linear(16, 64, device="meta")
    assert flops._count(lambda: lin(torch.empty(10, 16, device="meta"))) == 2 * 10 * 16 * 64


def test_serving_flops_are_the_counted_quadratic():
    per = flops.serving_flops_per_frames(8, 201)
    assert per(61) == flops.generator_forward_flops(8, 201, 61)


def test_k1_operations_and_bytes():
    ops, nbytes = flops.k1_ops_bytes(3232, 321)
    assert ops == 6 * 3232 * 4 * 321 * 321 * 16
    assert nbytes == 4 * 3232 * 321 * 4 * 16 * 4


def test_reference_schedule_matches_the_port():
    from speech_enhancement_tpu_torch.train import cyclic_cosine_schedule

    port = cyclic_cosine_schedule(0.01, 100, 64, 4, 4)
    for step in (0, 1, 64, 300, 1700, 3000, 6399):
        assert abs(port(step) - ref_train.cyclic_cosine(step, 0.01, 100, 64, 4, 4)) < 1e-15


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (harness.ROOT / "reference").glob("*.py"):
        assert not _imports(path) & (JAX_SIDE | {PORT}), path


def test_nothing_of_the_benchmark_imports_jax():
    for path in harness.ROOT.rglob("*.py"):
        if "tests" not in path.parts:
            assert not _imports(path) & JAX_SIDE, path


def test_a_process_that_loads_the_harness_and_the_reference_holds_no_jax():
    code = ("import sys, sebench.run, sebench.harness, sebench.serving, sebench.training, "
            "sebench.reference.train, sebench.reference.enhance\n"
            "from sebench import harness\n"
            "for kind in ('traffic', 'metrics'):\n"
            "    for p in (harness.ROOT / kind).glob('*.py'): harness.load_module(kind, p.stem)\n"
            "bad = sorted({n for n in sys.modules if n.split('.', 1)[0] in "
            f"{sorted(JAX_SIDE)!r}}})\n"
            f"port = sorted(n for n in sys.modules if n.split('.', 1)[0] == {PORT!r})\n"
            "print(bad, port)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT.parent, check=True).stdout.strip()
    assert out == "[] []", out


def test_the_forbidden_module_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "speech_enhancement_tpu_torch_x", object())
    assert "speech_enhancement_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "speech_enhancement_tpu.ops", object())
    assert harness.forbidden_modules() == ["speech_enhancement_tpu.ops"]
