"""The port's GAN entry points (speech_enhancement_tpu_torch/cli) end to end
on the CPU (``--device cpu``), on tests/test_cli.py's tiny VoiceBank-style
dataset (batch 2, 40-frame crops: 2 steps an epoch; 3 test utterances, so
the validation tail is padded and masked).  The CLIs build
``TSCNet(64, 201)`` and ``Discriminator(16)``; here they build
``TSCNet(8, 201)`` and ``Discriminator(4)``, as the JAX CLI tests do, so
that an epoch takes seconds.

* ``main_gan`` for one epoch in every step mode, with the fused-attention
  route (the kernels' plain versions on the CPU), in fp32 and bf16: finite
  losses, one discriminator update per generator step with the GAN term,
  the checkpoint and ``model_best`` written;
* ``inference_gan`` on its checkpoint prints and returns the six metrics
  and saves the wavs; ``--validate-epochs`` sweeps the checkpoints and
  fails loudly on an empty range;
* the step-mode flags as in the JAX CLI, ``_validation_pad_rows`` and
  ``host_validation_disc_loss`` equal to the JAX ones;
* without ``--device cpu`` both entry points raise on a host without a
  card.
"""

import numpy as np
import pytest
import torch

from speech_enhancement_tpu.cli import main_gan as jax_main_gan
from speech_enhancement_tpu_torch.cli import inference_gan, main_gan
from speech_enhancement_tpu_torch.data import save_wav
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("vb_port_cli")
    dirs = {}
    rng = np.random.default_rng(0)
    t = np.arange(20000) / 16000
    for split, n in [("train", 4), ("test", 3)]:
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


@pytest.fixture
def small_models(monkeypatch):
    for module in (main_gan, inference_gan):
        monkeypatch.setattr(module, "TSCNet",
                            lambda num_channel, num_features, **kw: TSCNet(8, num_features, **kw))
    monkeypatch.setattr(main_gan, "Discriminator", lambda ndf, **kw: Discriminator(4, **kw))


def train(cfg, out, *extra):
    return main_gan.main(["-a", "scp", "--cfg", cfg, "--output", str(out), "--seed", "3",
                          "-j", "2", "-p", "1", "--device", "cpu", *extra])


@pytest.mark.parametrize("step_mode, precision", [("two-phase", "fp32"), ("async", "bf16"),
                                                  ("pipelined", "bf16"), ("fused", "fp32")])
def test_main_gan_one_epoch_in_each_step_mode(tiny_dataset, small_models, step_mode,
                                              precision):
    root, cfg = tiny_dataset
    out = root / f"out_{step_mode}"
    history = train(cfg, out, "--epochs", "1", "--step-mode", step_mode, "--precision",
                    precision, "--fused-attention")
    (record,) = history
    stats = record["train"]
    assert len(stats.gen_losses) == 2 and np.isfinite(stats.gen_losses).all()
    assert stats.gan_steps == len(stats.disc_losses) == 2 and np.isfinite(stats.disc_losses).all()
    assert np.isfinite([record["valid_gen"], record["valid_disc"]]).all() and record["is_best"]
    run = out / "scp" / "default"
    assert (run / "checkpoint_0000" / "variables.pt").exists()
    assert (run / "model_best" / "state.pt").exists()


def test_inference_and_epoch_sweep(tiny_dataset, small_models, capsys):
    root, cfg = tiny_dataset
    out = root / "out_infer"
    train(cfg, out, "--epochs", "2", "--step-mode", "two-phase")
    run = out / "scp" / "default"
    metrics = inference_gan.main(["--cfg", cfg, "-m", str(run / "model_best"),
                                  "-o", str(root / "enhanced"), "--save", "--device", "cpu",
                                  "--fused-attention", "on", "--batch-size", "2"])
    printed = capsys.readouterr().out
    assert all(f"{name}: " in printed for name in ("pesq", "csig", "cbak", "covl", "ssnr",
                                                    "stoi"))
    assert metrics.shape == (6,) and np.isfinite(metrics).all()
    assert len(list((root / "enhanced").rglob("*.wav"))) == 3
    results = inference_gan.main(["--cfg", cfg, "-m", str(run), "-o", str(root / "sweep"),
                                  "--validate-epochs", "--device", "cpu", "--precision",
                                  "bf16"])
    assert [e for e, _ in results] == [0, 1]
    assert all(np.isfinite(m).all() for _, m in results)
    assert "Best epoch:" in capsys.readouterr().out


def test_validate_epochs_empty_range_fails_loudly(tiny_dataset, tmp_path):
    root, cfg = tiny_dataset
    empty = tmp_path / "no_ckpts"
    empty.mkdir()
    for extra in ([], ["--start", "0", "--end", "5"]):
        with pytest.raises(SystemExit, match="no restorable"):
            inference_gan.main(["--cfg", cfg, "-m", str(empty), "-o", str(tmp_path / "out"),
                                "--validate-epochs", "--device", "cpu", *extra])


def test_step_mode_flag(tiny_dataset):
    root, cfg = tiny_dataset
    base = ["-a", "scp", "--cfg", cfg, "--output", str(root / "o")]
    for extra, mode, lag in (([], "pipelined", 2), (["--step-mode", "fused"], "fused", 0),
                             (["--step-mode", "two-phase"], "two-phase", 0),
                             (["--async-disc"], "async", 1)):
        args, _ = main_gan.parse_option(base + extra)
        jargs, _ = jax_main_gan.parse_option(base + extra)
        assert (args.step_mode, args.disc_lag, args.async_disc) == (mode, lag, lag > 0)
        assert (args.step_mode, args.disc_lag, args.async_disc) == (
            jargs.step_mode, jargs.disc_lag, jargs.async_disc)
        assert args.precision == "fp32" and args.device is None
    with pytest.raises(SystemExit):
        main_gan.parse_option(base + ["--async-disc", "--step-mode", "fused"])


def test_validation_helpers_equal_jax():
    for b, batch_size, mesh in ((5, 12, 8), (12, 12, 8), (3, 32, 8), (1, 2, 1), (3, 2, 1)):
        assert main_gan._validation_pad_rows(b, batch_size, mesh) == \
            jax_main_gan._validation_pad_rows(b, batch_size, mesh)
    rng = np.random.default_rng(1)
    d_real, d_fake, q = (rng.uniform(0, 1, 5).astype(np.float32) for _ in range(3))
    for name in ("mse", "l2", "mae", "l1"):
        assert main_gan.host_validation_disc_loss(d_real, d_fake, q, name) == \
            jax_main_gan.host_validation_disc_loss(d_real, d_fake, q, name)
    with pytest.raises(ValueError):
        main_gan.host_validation_disc_loss(d_real, d_fake, q, "huber")


def test_entry_points_need_a_card_unless_told_cpu(tiny_dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    root, cfg = tiny_dataset
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_gan.main(["--cfg", cfg, "--output", str(tmp_path), "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference_gan.main(["--cfg", cfg, "-m", str(tmp_path), "-o", str(tmp_path)])
