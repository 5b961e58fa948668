"""The port's diffusion entry points (speech_enhancement_tpu_torch/cli/
main_diffuse.py, inference_diffuse.py, convert_checkpoint.py) end to end on
the CPU (``--device cpu``), on tests/test_cli.py's tiny VoiceBank-style
dataset (batch 2, 40-frame crops: 2 steps an epoch), its 3 test
utterances cut to 0.5 s (the samplers run every step at the full length).
DiffuSE is cut to 16 channels, 4 layers and a dilation cycle of 2 through
``--opts``; the diffusion TSCNet, whose width the CLI fixes at 64, is
built at width 8, as the JAX CLI tests do.

* ``main_diffuse`` for one epoch of each arch: finite losses, checkpoints
  and ``model_best``; ``--resume auto`` from the epoch-1 checkpoint equal
  bit for bit to two epochs straight (losses and weights); ``--init-from``
  loads the weights alone; the data-parallel flags other than one process
  on one device are refused;
* ``--opts`` overlays of ``NOISE_SCHEDULE`` (a count or the betas),
  ``RESIDUAL_LAYERS``, ``RESIDUAL_CHANNELS`` and ``CROP_FRAMES`` reach the
  config as the JAX package reads them, and the models built from it;
* ``inference_diffuse --fast`` (and ``--validate-epochs``, which skips a
  state-only checkpoint and fails loudly on an empty range) for both
  archs: six finite metrics, the wavs saved;
* ``predict_batch``: a singleton chunk at ``--sampler-batch 1`` equals
  ``predict`` exactly, mixed lengths and a silent utterance stay finite,
  and hops other than 100 work, on the kernels' geometry (n_fft 512, hop
  128) and off it (n_fft 400, hop 256: ``ops/stft.py``);
* ``convert_checkpoint``: reference-layout GAN and diffusion-trainer files
  (``module.`` prefixes) convert to weights equal bit for bit and to
  models whose outputs equal the source's bit for bit; the JAX package's
  converter, on the same files, gives flax models within relative RMS
  1e-5 of the converted port models; ``--to-torch`` writes a file that
  both converters read back; a file of the wrong structure, a standalone
  CDiffuSE ``weights.pt`` and an unknown layout raise;
* without ``--device cpu`` both diffusion CLIs raise on a host without a
  card.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_enhancement_tpu.config import get_config as jax_get_config
from speech_enhancement_tpu.models import DiffuSE as FlaxDiffuSE
from speech_enhancement_tpu.models import DiffusionTSCNet as FlaxDiffusionTSCNet
from speech_enhancement_tpu.utils.convert_torch import convert_checkpoint as jax_convert
from speech_enhancement_tpu_torch.cli import convert_checkpoint, inference_diffuse, main_diffuse
from speech_enhancement_tpu_torch.data import save_wav
from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet, Discriminator, TSCNet
from speech_enhancement_tpu_torch.ops.stft import compressed_stft
from speech_enhancement_tpu_torch.train import inference_schedule, linear_noise_schedule
from speech_enhancement_tpu_torch.utils import load_checkpoint, load_variables

torch.set_num_threads(1)

SMALL = ["--opts", "RESIDUAL_LAYERS", "4", "RESIDUAL_CHANNELS", "16",
         "DILATION_CYCLE_LENGTH", "2"]
FAST = inference_schedule(linear_noise_schedule(50), [0.0001, 0.001, 0.01, 0.05, 0.2, 0.35],
                          fast=True)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("vb_port_diffuse")
    dirs = {}
    rng = np.random.default_rng(0)
    for split, n, length in [("train", 4, 20000), ("test", 3, 8000)]:
        t = np.arange(length) / 16000
        cdir, ndir = root / f"clean_{split}", root / f"noisy_{split}"
        cdir.mkdir()
        ndir.mkdir()
        for i in range(n):
            clean = (0.3 * np.sin(2 * np.pi * (180 + 50 * i) * t)).astype(np.float32) * (
                0.5 + 0.5 * np.sin(2 * np.pi * 2.7 * t))
            noisy = clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32)
            save_wav(cdir / f"p{i:03d}.wav", clean)
            save_wav(ndir / f"p{i:03d}.wav", noisy)
        dirs[split] = (str(cdir), str(ndir))
    cfg = root / "tiny.yaml"
    cfg.write_text(f"""
DATA:
  TRAIN_CLEAN_DIR: {dirs['train'][0]}
  TRAIN_NOISY_DIR: {dirs['train'][1]}
  TEST_CLEAN_DIR: {dirs['test'][0]}
  TEST_NOISY_DIR: {dirs['test'][1]}
  BATCH_SIZE: 2
CROP_FRAMES: 40
""")
    return root, str(cfg)


def small_tsc(args, config, device=None):
    return DiffusionTSCNet(8, config.N_FFT // 2 + 1, len(config.NOISE_SCHEDULE), device=device,
                           generator=torch.Generator().manual_seed(getattr(args, "seed", 0) or 0))


@pytest.fixture
def small_models(monkeypatch):
    real = main_diffuse.build_model

    def build(args, config, device=None):
        return real(args, config, device) if args.arch == "diffuse" else small_tsc(
            args, config, device)

    for module in (main_diffuse, inference_diffuse):
        monkeypatch.setattr(module, "build_model", build)


def train(cfg, out, arch, *extra):
    return main_diffuse.main(["-a", arch, "--cfg", cfg, "--output", str(out), "--seed", "3",
                              "-j", "2", "-p", "1", "--device", "cpu", *SMALL, *extra])


def run_dir(out, arch):
    return out / arch / "default"


@pytest.mark.parametrize("arch", ["diffuse", "tsc-diffuse"])
def test_main_diffuse_one_epoch(tiny_dataset, small_models, arch):
    root, cfg = tiny_dataset
    out = root / f"out_{arch}"
    (record,) = train(cfg, out, arch, "--epochs", "1")
    assert len(record["train_losses"]) == 2 and np.isfinite(record["train_losses"]).all()
    assert np.isfinite(record["valid_loss"]) and record["valid_loss"] > 0 and record["is_best"]
    run = run_dir(out, arch)
    assert (run / "checkpoint_0000" / "variables.pt").exists()
    assert load_checkpoint(str(run / "model_best"))["epoch"] == 1
    model = load_variables(str(run / "checkpoint_0000"))["model"]
    if arch == "diffuse":  # the --opts sizes reached the model
        assert model["input_projection.weight"].shape[0] == 16
        assert "residual_layers.3.dilated_conv.0.weight" in model
        assert "residual_layers.4.dilated_conv.0.weight" not in model


@pytest.mark.parametrize("arch", ["diffuse", "tsc-diffuse"])
def test_resume_auto_is_bit_exact(tiny_dataset, small_models, arch):
    root, cfg = tiny_dataset
    common = ("--lr", "1e-3", "--optimizer", "adamw")
    straight = train(cfg, root / f"straight_{arch}", arch, "--epochs", "2", *common)
    train(cfg, root / f"resumed_{arch}", arch, "--epochs", "1", *common)
    (resumed,) = train(cfg, root / f"resumed_{arch}", arch, "--epochs", "2", "--resume",
                       "auto", *common)
    assert resumed["epoch"] == 1
    assert resumed["train_losses"] == straight[1]["train_losses"]
    assert resumed["valid_loss"] == straight[1]["valid_loss"]
    got, want = (load_checkpoint(str(run_dir(root / f"{kind}_{arch}", arch) / "checkpoint_0001"))
                 for kind in ("resumed", "straight"))
    for key, value in want["model"].items():
        torch.testing.assert_close(got["model"][key], value, rtol=0, atol=0, msg=key)
    assert got["step"] == want["step"] == 4 and got["epoch"] == want["epoch"] == 2


def test_init_from_loads_weights_only(tiny_dataset, small_models):
    root, cfg = tiny_dataset
    src = root / "init_src"
    train(cfg, src, "diffuse", "--epochs", "1")
    ckpt = run_dir(src, "diffuse") / "checkpoint_0000"
    dst = root / "init_dst"
    captured = {}
    real_step = main_diffuse.diffuse_step

    def spy(state, *a, **kw):
        captured.setdefault("weights", {k: v.clone() for k, v in state.model.state_dict().items()})
        captured.setdefault("step", state.step)
        return real_step(state, *a, **kw)

    main_diffuse.diffuse_step = spy
    try:
        train(cfg, dst, "diffuse", "--epochs", "1", "--seed", "5", "--init-from", str(ckpt))
    finally:
        main_diffuse.diffuse_step = real_step
    for key, value in load_variables(str(ckpt))["model"].items():
        torch.testing.assert_close(captured["weights"][key], value, rtol=0, atol=0)
    assert captured["step"] == 0
    with pytest.raises(SystemExit):
        train(cfg, root / "both", "diffuse", "--epochs", "1", "--init-from", str(ckpt),
              "--resume", "auto")


@pytest.mark.parametrize("flags", [["--n-devices", "2"], ["--num-processes", "2"],
                                   ["--coordinator", "localhost:1234"],
                                   ["--process-id", "1"]])
def test_data_parallel_flags_are_refused(tiny_dataset, flags, capsys):
    _, cfg = tiny_dataset
    with pytest.raises(SystemExit):
        main_diffuse.parse_option(["--cfg", cfg, *flags])
    assert "one process trains on one device" in capsys.readouterr().err
    args, _ = main_diffuse.parse_option(["--cfg", cfg, "--n-devices", "1", "--num-processes",
                                         "1", "--process-id", "0"])
    assert args.n_devices == 1


@pytest.mark.parametrize("opts", [
    ["NOISE_SCHEDULE", "40", "RESIDUAL_LAYERS", "6", "RESIDUAL_CHANNELS", "32",
     "CROP_FRAMES", "80"],
    ["NOISE_SCHEDULE", "[0.0001, 0.01, 0.02, 0.05]", "CROP_FRAMES", "20"],
])
def test_opts_reach_the_diffusion_clis(tiny_dataset, opts):
    _, cfg = tiny_dataset
    argv = ["-a", "diffuse", "--cfg", cfg, "--opts", *opts]
    args, config = main_diffuse.parse_option(argv)
    _, icfg = inference_diffuse.parse_option(["-o", "x", "-m", "y", *argv])
    ns = argparse.Namespace(cfg=cfg, opts=opts, arch="diffuse")
    if opts[1].startswith("["):
        # the JAX reader casts a list given for an int key to int and fails;
        # the port keeps the betas
        assert config.NOISE_SCHEDULE == [0.0001, 0.01, 0.02, 0.05]
    else:
        want = jax_get_config(ns)
        for key in ("NOISE_SCHEDULE", "RESIDUAL_LAYERS", "RESIDUAL_CHANNELS", "CROP_FRAMES"):
            assert getattr(config, key) == getattr(icfg, key) == getattr(want, key), key
    assert icfg.NOISE_SCHEDULE == config.NOISE_SCHEDULE
    model = main_diffuse.build_model(args, config, "cpu")
    assert len(model.residual_layers) == config.RESIDUAL_LAYERS
    assert model.input_projection.out_channels == config.RESIDUAL_CHANNELS
    assert model.diffusion_embedding.embedding.shape[0] == len(config.NOISE_SCHEDULE)


@pytest.mark.parametrize("arch", ["diffuse", "tsc-diffuse"])
def test_inference_and_epoch_sweep(tiny_dataset, small_models, arch, capsys):
    root, cfg = tiny_dataset
    out = root / f"infer_{arch}"
    train(cfg, out, arch, "--epochs", "1")
    run = run_dir(out, arch)
    common = ["-a", arch, "--cfg", cfg, "--fast", "--device", "cpu", *SMALL]
    metrics = inference_diffuse.main([*common, "-m", str(run / "model_best"),
                                      "-o", str(root / f"enh_{arch}"), "--save",
                                      "--sampler-batch", "2"])
    assert metrics.shape == (6,) and np.isfinite(metrics).all()
    assert len(list((root / f"enh_{arch}").rglob("*.wav"))) == 3
    (run / "checkpoint_0001").mkdir()  # an emergency save: state only
    torch.save({}, run / "checkpoint_0001" / "state.pt")
    results = inference_diffuse.main([*common, "-m", str(run), "-o", str(root / "sweep"),
                                      "--validate-epochs"])
    printed = capsys.readouterr().out
    assert [e for e, _ in results] == [0] and np.isfinite(results[0][1]).all()
    assert "skipping epoch 1" in printed and "Best epoch: 0" in printed
    empty = root / f"empty_{arch}"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no restorable"):
        inference_diffuse.main([*common, "-m", str(empty), "-o", str(root / "s2"),
                                "--validate-epochs"])


def predict_args(arch, sampler_batch):
    return argparse.Namespace(arch=arch, comp_type="pow", sampler_batch=sampler_batch)


@pytest.mark.parametrize("arch", ["diffuse", "tsc-diffuse"])
def test_predict_batch_singleton_equals_predict(arch):
    cfg = argparse.Namespace(HOP_SAMPLES=100, N_FFT=400)
    model = (DiffuSE(dilation_cycle_length=2, residual_channels=16, residual_layers=2,
                     device="cpu") if arch == "diffuse" else DiffusionTSCNet(8, device="cpu"))
    rng = np.random.default_rng(1)
    sig = (0.1 * rng.standard_normal(4000)).astype(np.float32)
    for s in (sig, sig[:4000 - 37]):  # a hop multiple, and not
        serial = inference_diffuse.predict(model, predict_args(arch, 1), cfg, s, FAST, 7, "cpu")
        (batched,) = inference_diffuse.predict_batch(model, predict_args(arch, 1), cfg, [s],
                                                     FAST, 7, "cpu")
        np.testing.assert_array_equal(serial, batched)
        # the waveform sampler frames the raw signal to whole hops
        assert len(serial) == (len(s) // 100 * 100 if arch == "diffuse" else len(s))
    short = (0.1 * rng.standard_normal(3300)).astype(np.float32)
    silent = np.zeros(4000, np.float32)
    outs = inference_diffuse.predict_batch(model, predict_args(arch, 3), cfg,
                                           [sig, short, silent], FAST, 7, "cpu")
    assert [len(o) for o in outs] == [4000, 3300, 4000]
    assert all(np.isfinite(o).all() for o in outs)


@pytest.mark.parametrize("n_fft, hop", [(512, 128), (400, 256)])
def test_predict_batch_other_hops(n_fft, hop):
    """Buckets of ``max(hop, 8000 - 8000 % hop)``: 8000 is no multiple of
    128 or 256.  n_fft 512 / hop 128 is a geometry K4 and K5 take; 400 /
    256 is not, and samples through ``ops/stft.py``."""
    cfg = argparse.Namespace(HOP_SAMPLES=hop, N_FFT=n_fft)
    model = DiffusionTSCNet(8, n_fft // 2 + 1, device="cpu")
    rng = np.random.default_rng(2)
    sigs = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (4000, 3300)]
    outs = inference_diffuse.predict_batch(model, predict_args("tsc-diffuse", 2), cfg, sigs,
                                           FAST, 7, "cpu")
    assert [len(o) for o in outs] == [4000, 3300]
    assert all(np.isfinite(o).all() for o in outs)


def reference_file(path, **entries):
    """A reference-layout checkpoint: every state_dict under DDP's
    ``module.`` prefix."""
    torch.save({k: ({f"module.{n}": t for n, t in v.items()} if isinstance(v, dict) else v)
                for k, v in entries.items()}, path)


def rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def test_convert_diffusion_trainer_files(tmp_path, capsys):
    rng = np.random.default_rng(3)
    audio = torch.from_numpy((0.3 * rng.standard_normal((2, 4000))).astype(np.float32))
    cond = torch.from_numpy(np.abs(rng.standard_normal((2, 40, 201))).astype(np.float32))
    spec = compressed_stft(audio, 400, 100)
    t = torch.tensor([3, 30])
    for arch, src in (
            ("diffuse", DiffuSE(dilation_cycle_length=10, residual_channels=16,
                                residual_layers=3, device="cpu",
                                generator=torch.Generator().manual_seed(4))),
            ("tsc-diffuse", DiffusionTSCNet(8, device="cpu",
                                            generator=torch.Generator().manual_seed(5)))):
        with torch.no_grad():  # move the zero-initialized output conv
            for p in src.parameters():
                p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(6)))
        src.eval()
        path = tmp_path / f"{arch}.pth.tar"
        reference_file(path, epoch=7, arch=arch, state_dict=src.state_dict())
        out = tmp_path / f"conv_{arch}"
        assert convert_checkpoint.main([str(path), str(out)]) == 0
        assert f"inference_diffuse -a {arch}" in capsys.readouterr().out
        converted = load_variables(str(out))["model"]
        for key, value in src.state_dict().items():
            torch.testing.assert_close(converted[key], value, rtol=0, atol=0)
        model = (convert_checkpoint.diffuse_from_state_dict(converted) if arch == "diffuse"
                 else DiffusionTSCNet(8, device="cpu"))
        model.load_state_dict(converted)
        model.eval()
        inputs = (audio, cond, t) if arch == "diffuse" else (spec, spec, t)
        with torch.no_grad():
            got, want = as_tuple(model(*inputs)), as_tuple(src(*inputs))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        # the JAX package's converter on the same file, through the flax model
        jvars = jax_convert(str(path))["model"]
        if arch == "diffuse":
            flax = FlaxDiffuSE(dilation_cycle_length=10, residual_channels=16, residual_layers=3)
            jout = flax.apply(jvars, audio.numpy(), cond.numpy(), t.numpy())
        else:
            flax = FlaxDiffusionTSCNet(num_channel=8)
            jout = flax.apply(jvars, jnp.asarray(spec.numpy()), jnp.asarray(spec.numpy()),
                              t.numpy(), deterministic=True)
        for g, j in zip(got, as_tuple(jout)):
            assert rel_rms(g.numpy(), np.asarray(j)) < 1e-5
        with pytest.raises(SystemExit, match="refusing to overwrite"):
            convert_checkpoint.main([str(path), str(out)])


def test_convert_gan_files_and_export_back(tmp_path):
    gen = TSCNet(64, 201, device="cpu", generator=torch.Generator().manual_seed(1))
    disc = Discriminator(16, device="cpu", generator=torch.Generator().manual_seed(2))
    path = tmp_path / "model_best.pth.tar"
    reference_file(path, epoch=3, arch="scp", gen_state_dict=gen.state_dict(),
                   disc_state_dict=disc.state_dict())
    assert convert_checkpoint.main([str(path), str(tmp_path / "conv")]) == 0
    variables = load_variables(str(tmp_path / "conv"))
    for name, module in (("gen", gen), ("disc", disc)):
        for key, value in module.state_dict().items():
            torch.testing.assert_close(variables[name][key], value, rtol=0, atol=0)
    # back to the reference layout: both converters read it
    back = tmp_path / "back.pth.tar"
    assert convert_checkpoint.main([str(tmp_path / "conv"), str(back), "--to-torch",
                                    "--epoch", "9"]) == 0
    raw = torch.load(back, weights_only=True)
    assert raw["epoch"] == 9 and raw["arch"] == "scp"
    assert all(k.startswith("module.") for k in raw["gen_state_dict"])
    again = convert_checkpoint.convert(str(back))
    for key, value in gen.state_dict().items():
        torch.testing.assert_close(again["gen"][key], value, rtol=0, atol=0)
    assert set(jax_convert(str(back))) == {"gen", "disc"}
    # a generator alone gets a fresh discriminator
    reference_file(tmp_path / "gen_only.pth.tar", gen_state_dict=gen.state_dict())
    assert set(convert_checkpoint.convert(str(tmp_path / "gen_only.pth.tar"))) == {"gen", "disc"}
    with pytest.raises(SystemExit, match="no variables.pt"):
        convert_checkpoint.main([str(path), str(tmp_path / "x.pth.tar"), "--to-torch"])


def test_convert_refuses_what_it_cannot_convert(tmp_path):
    model = DiffuSE(residual_channels=16, residual_layers=2, device="cpu")
    sd = model.state_dict()
    cases = {
        "missing": {"arch": "diffuse", "state_dict": {k: v for k, v in sd.items()
                                                      if "output_residual" not in k}},
        "reshaped": {"arch": "diffuse", "state_dict": {**sd, "skip_projection.weight":
                                                       torch.zeros(16, 16, 3)}},
        "disc_only": {"disc_state_dict": Discriminator(4, device="cpu").state_dict()},
        "cdiffuse": {"step": 10, "model": sd},
        "unknown": {"weights": sd},
    }
    messages = {"missing": "do not fit", "reshaped": "do not fit", "disc_only": "no gen_state_dict",
                "cdiffuse": "not ported yet", "unknown": "unrecognized"}
    for name, ckpt in cases.items():
        torch.save(ckpt, tmp_path / f"{name}.pt")
        with pytest.raises(SystemExit, match=messages[name]):
            convert_checkpoint.main([str(tmp_path / f"{name}.pt"), str(tmp_path / name)])
        assert not (tmp_path / name / "variables.pt").exists()
    torch.save({"state_dict": sd, "note": argparse.Namespace(a=1)}, tmp_path / "pickled.pt")
    with pytest.raises(SystemExit, match="does not unpickle"):
        convert_checkpoint.main([str(tmp_path / "pickled.pt"), str(tmp_path / "p")])


def test_diffusion_entry_points_need_a_card_unless_told_cpu(tiny_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    _, cfg = tiny_dataset
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_diffuse.main(["--cfg", cfg, "--output", str(tmp_path), "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference_diffuse.main(["--cfg", cfg, "-m", str(tmp_path), "-o", str(tmp_path)])
