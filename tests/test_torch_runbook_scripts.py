"""The port's label-bias study and quality-parity runbook
(speech_enhancement_tpu_torch/scripts/label_bias_study.py and
run_quality_parity.py) against the JAX scripts of the same names, on the
CPU:

* the study's ``ARMS`` are the JAX script's; ``run_arm`` runs the port's
  ``train_quality_proxy`` with the JAX arm flags, both label knobs in its
  environment, ``--device`` and the ``extra`` flags; on the same six arm
  records (no arm trains) the JAX and port ``main`` write byte-equal table
  rows and JSON records;
* the runbook's dry run prints the reference recipe through the port's
  CLIs, its ``--model_path`` is where the port's ``main_gan`` writes
  (``config.OUTPUT``); the port's ``parity.yaml`` loads through the port's
  ``load_config`` with the four data directories, while the JAX script's
  overlay, whose ``BASE`` is relative to itself, raises
  ``FileNotFoundError`` in the JAX loader (a defect of the JAX script,
  kept there); ``parse_sweep_output`` reads the JAX test's text and a real
  ``inference_gan --validate-epochs`` output of the port;
* each of the four new scripts raises on a host without a card unless
  given ``--device cpu``, before it writes anything.
"""

import importlib
import json
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.cli import inference_gan
from speech_enhancement_tpu_torch.config import load_config
from speech_enhancement_tpu_torch.data import save_wav
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.scripts import label_bias_study as lbs
from speech_enhancement_tpu_torch.scripts import run_quality_parity as rqp
from speech_enhancement_tpu_torch.utils import save_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_module(name):
    return importlib.import_module(f"scripts.{name}")


# ---------------------------------------------------------------------------
# label_bias_study

def test_arms_equal_jax():
    assert lbs.ARMS == jax_module("label_bias_study").ARMS


def write_arm_records(root):
    """Six arm records in the layout ``train_quality_proxy`` writes."""
    rng = np.random.default_rng(5)
    noisy = [2.531, 1.0, 2.706, 1.05, 0.621, 0.802]
    for name, _, _ in lbs.ARMS:
        arm_root = os.path.join(root, name.replace("+", "p").replace("-", "m"))
        os.makedirs(arm_root, exist_ok=True)
        per_epoch = {str(e): [float(v) for v in 3.0 + rng.uniform(0, 1, 6)] for e in range(8)}
        with open(os.path.join(arm_root, "ab_scp.json"), "w") as f:
            json.dump({"arch": "scp", "noisy": noisy, "per_epoch": per_epoch}, f, indent=1)


@pytest.mark.parametrize("name, bias, noise", [("bias-0.3", -0.3, 0.0),
                                               ("noise0.1", 0.0, 0.1)])
def test_run_arm_passes_both_knobs(tmp_path, monkeypatch, name, bias, noise):
    seen = {}

    def run(cmd, env, cwd):
        seen.update(cmd=cmd, env=env, cwd=cwd)
        write_arm_records(str(tmp_path / seen["side"]))
        return type("Done", (), {"returncode": 0})()

    monkeypatch.setattr(lbs.subprocess, "run", run)
    jax_lbs = jax_module("label_bias_study")
    monkeypatch.setattr(jax_lbs.subprocess, "run", run)
    calls = {}
    for side, run_arm in (
            ("jax", lambda root: jax_lbs.run_arm(name, bias, noise, root, 8)),
            ("port", lambda root: lbs.run_arm(name, bias, noise, root, 8, "cpu",
                                              extra=("--train-pairs", "16")))):
        seen.clear()
        seen["side"] = side
        assert run_arm(str(tmp_path / side))["arch"] == "scp"
        calls[side] = dict(seen)
    port, want = calls["port"], calls["jax"]
    for env in (port["env"], want["env"]):
        assert env["SE_TPU_PESQ_LABEL_BIAS"] == str(bias)
        assert env["SE_TPU_PESQ_LABEL_NOISE"] == str(noise)
    assert port["cmd"][:3] == [sys.executable, "-m",
                               "speech_enhancement_tpu_torch.scripts.train_quality_proxy"]
    assert want["cmd"][1].endswith(os.path.join("scripts", "train_quality_proxy.py"))
    # the JAX arm flags (under the port's root), then --device and the extras
    flags = [a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in want["cmd"][2:]]
    assert port["cmd"][3:] == flags + ["--device", "cpu", "--train-pairs", "16"]
    assert port["cwd"] == REPO


def test_study_tables_and_records_equal_jax(tmp_path, monkeypatch, capsys):
    write_arm_records(str(tmp_path))
    jax_lbs = jax_module("label_bias_study")

    def no_training(*a, **kw):
        raise AssertionError("an arm trained although its record exists")

    monkeypatch.setattr(jax_lbs.subprocess, "run", no_training)
    monkeypatch.setattr(lbs.subprocess, "run", no_training)
    assert lbs.main(["--root", str(tmp_path), "--report", str(tmp_path / "port" / "lb.md"),
                     "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["label_bias_study.py", "--root", str(tmp_path),
                                      "--report", str(tmp_path / "jax" / "lb.md")])
    assert jax_lbs.main() == 0
    assert capsys.readouterr().out.count("record exists, skipping") == 12

    def rows(side):
        text = (tmp_path / side / "lb.md").read_text()
        return [line for line in text.splitlines() if line.startswith("|")
                or line.startswith("Largest")]

    assert len(rows("port")) == 9 and rows("port") == rows("jax")
    assert (tmp_path / "port" / "lb.json").read_bytes() == \
        (tmp_path / "jax" / "lb.json").read_bytes()
    assert (tmp_path / "port" / "lb.md").read_text().startswith(
        "# PESQ label-bias sensitivity study\n")


# ---------------------------------------------------------------------------
# run_quality_parity

def test_dry_run_prints_reference_recipe(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "speech_enhancement_tpu_torch.scripts.run_quality_parity",
         "--train-clean", str(tmp_path), "--train-noisy", str(tmp_path),
         "--test-clean", str(tmp_path), "--test-noisy", str(tmp_path),
         "--arch", "scp", "cmgan", "-o", str(tmp_path / "runs"), "--device", "cpu",
         "--dry-run"],
        text=True, capture_output=True, timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    # the reference recipe: MSE criterion, gen-first, resume auto, both
    # archs, the best-PESQ sweep, and the SCP loss-weight overlay
    assert "-a scp" in out.stdout and "-a cmgan" in out.stdout
    assert "--criterion mse" in out.stdout
    assert "--gen-first" in out.stdout
    assert "--resume auto" in out.stdout
    assert "--validate-epochs" in out.stdout
    assert "[0.3,0.7,0.2,0.05]" in out.stdout  # scp.yaml:6 weights
    assert "[0.1,0.9,0.2,0.05]" in out.stdout  # cmgan baseline weights
    assert (tmp_path / "runs" / "parity.yaml").exists()
    lines = [line for line in out.stdout.splitlines() if line.startswith("$ ")]
    assert len(lines) == 4
    assert all(" -m speech_enhancement_tpu_torch.cli." in line for line in lines)
    assert all(line.endswith("--device cpu") or "--device cpu --opts" in line
               for line in lines)
    assert "speech_enhancement_tpu.cli" not in out.stdout


def runbook_args(tmp_path):
    """The runbook's parsed flags at their defaults, and its output
    directory."""
    args = Namespace(train_clean=str(tmp_path / "tc"), train_noisy=str(tmp_path / "tn"),
                     test_clean=str(tmp_path / "vc"), test_noisy=str(tmp_path / "vn"),
                     epochs=100, batch_size=8, sweep_last=20, step_mode="async",
                     train_precision="bf16", precision="bf16", device=None)
    out_dir = str(tmp_path / "runs")
    os.makedirs(out_dir, exist_ok=True)
    return args, out_dir


@pytest.mark.parametrize("arch", ["scp", "cmgan"])
def test_commands_match_jax_and_the_port_output(tmp_path, arch):
    args, out_dir = runbook_args(tmp_path)
    jax_rqp = jax_module("run_quality_parity")
    cfg = rqp.build_config(out_dir, args)
    train, sweep = rqp.commands_for(arch, cfg, out_dir, args)
    jax_train, jax_sweep = jax_rqp.commands_for(arch, cfg, out_dir, args)
    assert train[2] == "speech_enhancement_tpu_torch.cli.main_gan"
    assert sweep[2] == "speech_enhancement_tpu_torch.cli.inference_gan"
    assert train[3:] == jax_train[3:] and sweep[3:] == jax_sweep[3:]
    # --model_path is the training run's config.OUTPUT, as main_gan computes it
    from speech_enhancement_tpu_torch.cli import main_gan
    _, config = main_gan.parse_option(train[3:])
    model_path = sweep[sweep.index("--model_path") + 1]
    assert model_path == config.OUTPUT == os.path.join(out_dir, arch, arch, "parity")
    args.device = "cpu"
    train, sweep = rqp.commands_for(arch, cfg, out_dir, args)
    assert train[train.index("--device") + 1] == "cpu" == sweep[sweep.index("--device") + 1]


def test_port_overlay_loads_and_the_jax_one_does_not(tmp_path):
    args, out_dir = runbook_args(tmp_path)
    cfg = load_config(rqp.build_config(out_dir, args))
    assert cfg.DATA.TRAIN_CLEAN_DIR == str(tmp_path / "tc")
    assert cfg.DATA.TRAIN_NOISY_DIR == str(tmp_path / "tn")
    assert cfg.DATA.TEST_CLEAN_DIR == str(tmp_path / "vc")
    assert cfg.DATA.TEST_NOISY_DIR == str(tmp_path / "vn")
    assert cfg.LOSS_WEIGHTS == [0.3, 0.7, 0.2, 0.05]  # scp.yaml over baseline.yaml
    assert cfg.N_FFT == 400
    # the JAX script writes BASE: ['scp.yaml'], which both loaders resolve
    # against the overlay's own directory: a real run fails to load it
    from speech_enhancement_tpu.config import load_config as jax_load_config

    jax_dir = tmp_path / "jax_runs"
    jax_dir.mkdir()
    jax_cfg = jax_module("run_quality_parity").build_config(str(jax_dir), args)
    with pytest.raises(FileNotFoundError, match="scp.yaml"):
        jax_load_config(jax_cfg)
    with pytest.raises(FileNotFoundError, match="scp.yaml"):
        load_config(jax_cfg)


def test_parse_sweep_output():
    text = (
        "Epoch: 98\n"
        "pesq: 3.101\t csig: 4.400\t cbak: 3.700\t covl: 3.800\t "
        "ssnr: 10.100\t stoi: 0.950\n"
        "Epoch: 99\n"
        "pesq: 3.201\t csig: 4.500\t cbak: 3.800\t covl: 3.900\t "
        "ssnr: 10.200\t stoi: 0.955\n"
        "Best epoch: 99\t best PESQ: 3.201\n"
    )
    epoch, row = rqp.parse_sweep_output(text)
    assert epoch == 99
    assert row == (3.201, 4.5, 3.8, 3.9, 10.2, 0.955)
    assert rqp.REFERENCE_ROWS == jax_module("run_quality_parity").REFERENCE_ROWS


def test_parse_sweep_output_reads_the_port_sweep(tmp_path, monkeypatch, capsys):
    """Two checkpoints of a width-8 generator swept by the port's
    ``inference_gan --validate-epochs``: the parsed row is the best epoch's
    printed metrics."""
    monkeypatch.setattr(inference_gan, "TSCNet",
                        lambda num_channel, num_features, **kw: TSCNet(8, num_features, **kw))
    rng = np.random.default_rng(0)
    for d in ("clean", "noisy"):
        (tmp_path / d).mkdir()
    t = np.arange(8000) / 16000
    for i in range(2):
        clean = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(np.float32)
        save_wav(tmp_path / "clean" / f"u{i}.wav", clean)
        save_wav(tmp_path / "noisy" / f"u{i}.wav",
                 clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32))
    for epoch in range(2):
        gen = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(epoch))
        save_checkpoint({}, str(tmp_path / "ckpt"), epoch, variables={"gen": gen.state_dict()})
    results = inference_gan.main([
        "--cfg", os.path.join(rqp.CONFIG_DIR, "scp.yaml"), "--output", str(tmp_path / "enh"),
        "--model_path", str(tmp_path / "ckpt"), "--validate-epochs", "--start", "0",
        "--end", "2", "--device", "cpu", "--opts", "DATA.TEST_CLEAN_DIR",
        str(tmp_path / "clean"), "DATA.TEST_NOISY_DIR", str(tmp_path / "noisy")])
    epoch, row = rqp.parse_sweep_output(capsys.readouterr().out)
    best = max(results, key=lambda r: r[1][0])
    assert epoch == best[0] and [e for e, _ in results] == [0, 1]
    np.testing.assert_allclose(row, best[1], atol=5e-4)  # printed to 3 decimals


# ---------------------------------------------------------------------------
# every new script needs a card unless told cpu

@pytest.mark.parametrize("name", ["run_full_recipe_proxy", "label_bias_study",
                                  "run_quality_parity", "make_pesq_validation_set"])
def test_script_needs_a_card_unless_told_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    module = importlib.import_module(f"speech_enhancement_tpu_torch.scripts.{name}")
    out = tmp_path / "r"
    argv = {"run_quality_parity": ["--train-clean", str(tmp_path), "--train-noisy",
                                   str(tmp_path), "--test-clean", str(tmp_path),
                                   "--test-noisy", str(tmp_path), "-o", str(out)],
            "make_pesq_validation_set": ["--conformance", "--out", str(out / "c.json")],
            }.get(name, ["--root", str(out)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not out.exists()
