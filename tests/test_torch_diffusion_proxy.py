"""The port's diffusion quality scripts (speech_enhancement_tpu_torch/
scripts/train_diffusion_proxy.py and train_cdiffuse_proxy.py) end to end
on the CPU (``--device cpu``), at the smallest size their flags allow: a
corpus of 4 + 2 pairs of 1 s, batch 2, a few steps, and a 6-step
``--fast`` sweep.  The models are cut as the CLI tests cut them: the
diffusion TSCNet to width 8 (tests/test_torch_diffuse_cli.py), the
learner's DiffuSE to 8 channels and 4 layers
(tests/test_torch_cdiffuse_learner.py).

Each script writes its report in the JAX scripts' format (the header, the
six-metric table with the noisy row and one row per swept checkpoint, the
summary line that tests/test_diffusion_proxy.py parses) and its JSON
record, and returns the PASS/FAIL exit code of the JAX scripts' gate.
"""

import json
import re

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.cli import (
    cdiffuse,
    cdiffuse_inference,
    inference_diffuse,
    main_diffuse,
)
from speech_enhancement_tpu_torch.models import DiffusionTSCNet
from speech_enhancement_tpu_torch.scripts import train_cdiffuse_proxy, train_diffusion_proxy

torch.set_num_threads(1)

TABLE = ["| checkpoint | PESQ | CSIG | CBAK | COVL | SSNR | STOI |",
         "|---|---|---|---|---|---|---|"]
ROW = r"\| {label} {key} \|( -?[\d.]+ \|){{6}}"


def check_report(text, title, label, keys, rc, printed):
    lines = text.splitlines()
    assert lines[0] == title and lines[1] == ""
    start = lines.index(TABLE[0])
    assert lines[start:start + 2] == TABLE
    assert re.fullmatch(ROW.format(label="noisy", key=r"\(baseline\)"), lines[start + 2])
    for i, key in enumerate(keys):
        assert re.fullmatch(ROW.format(label=label, key=key), lines[start + 3 + i])
    summary = re.search(r"Best (\w+) (\d+): PESQ ([\d.]+) vs noisy ([\d.]+) "
                        r"\(Δ ([+-][\d.]+)\); STOI ([\d.]+) vs ([\d.]+) \(Δ ([+-][\d.]+)\)\.",
                        lines[-1])
    assert summary and summary.group(1) == label and int(summary.group(2)) in keys
    assert lines[-2] == ""
    assert rc == (0 if float(summary.group(5)) > 0 else 1)
    assert f"RESULT: {'PASS' if rc == 0 else 'FAIL'}" in printed
    assert "on the CPU." in text


def small_tsc(args, config, device=None):
    return DiffusionTSCNet(8, config.N_FFT // 2 + 1, len(config.NOISE_SCHEDULE), device=device,
                           generator=torch.Generator().manual_seed(args.seed or 0))


def test_diffusion_proxy_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    for module in (main_diffuse, inference_diffuse):
        monkeypatch.setattr(module, "build_model", small_tsc)
    root = tmp_path / "diffusion"
    rc = train_diffusion_proxy.main([
        "--root", str(root), "--train-pairs", "4", "--test-pairs", "2", "--seconds", "1",
        "--epochs", "1", "--eval-every", "1", "--batch-size", "2", "--fast",
        "--device", "cpu"])
    text = (root / "diffusion_proxy_run.md").read_text()
    check_report(text, "# Diffusion training-to-quality proxy run (synthetic corpus)", "epoch",
                 [0], rc, capsys.readouterr().out)
    assert "1 epochs x 2 steps, adamw lr 2e-4" in text
    assert "sampled with the 6-step --fast reverse schedule" in text
    record = json.loads((root / "diffusion_tsc-diffuse_fast.json").read_text())
    assert record["arch"] == "tsc-diffuse" and record["fast"] and record["epochs"] == 1
    assert record["lr"] == "2e-4" and record["batch_size"] == 2 and record["seed"] == 3
    assert sorted(record["per_epoch"]) == ["0"]
    assert all(len(v) == 6 and np.isfinite(v).all()
               for v in [record["noisy"], *record["per_epoch"].values()])


def test_cdiffuse_proxy_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cdiffuse, "PARAMS", dict(cdiffuse.PARAMS, residual_channels=8,
                                                 residual_layers=4))
    root = tmp_path / "cdiffuse"
    rc = train_cdiffuse_proxy.main([
        "--root", str(root), "--train-pairs", "4", "--test-pairs", "2", "--seconds", "1",
        "--max-steps", "4", "--eval-every", "2", "--batch-size", "2", "--fast",
        "--device", "cpu"])
    text = (root / "cdiffuse_proxy_run.md").read_text()
    check_report(text, "# CDiffuSE standalone training-to-quality proxy run (synthetic corpus)",
                 "step", [2, 4], rc, capsys.readouterr().out)
    assert "4 steps of batch 2 x 1s crops" in text
    record = json.loads((root / "cdiffuse_fast.json").read_text())
    assert record == {**record, "fast": True, "max_steps": 4, "seed": 3, "batch_size": 2}
    assert sorted(record["per_step"]) == ["2", "4"]
    assert all(len(v) == 6 and np.isfinite(v).all()
               for v in [record["noisy"], *record["per_step"].values()])
    assert not cdiffuse_inference._model_cache


@pytest.mark.parametrize("arch", ["tsc-diffuse", "diffuse"])
def test_diffusion_proxy_passes_the_jax_training_flags(tmp_path, monkeypatch, arch):
    """``main_diffuse`` gets the JAX script's flags at their defaults (60
    epochs, adamw 2e-4, seed 3), the port's baseline overlay and
    ``--device``."""
    seen = {}

    def stop(argv):
        seen["argv"] = argv
        raise SystemExit("stop")

    monkeypatch.setattr(main_diffuse, "main", stop)
    with pytest.raises(SystemExit, match="stop"):
        train_diffusion_proxy.main(["--root", str(tmp_path), "--arch", arch, "--train-pairs",
                                    "1", "--test-pairs", "1", "--seconds", "0.1",
                                    "--device", "cpu"])
    argv = seen["argv"]
    assert argv[:2] == ["-a", arch] and argv[argv.index("--device") + 1] == "cpu"
    assert argv[argv.index("--cfg") + 1].endswith("speech_enhancement_tpu_torch/config/"
                                                  "baseline.yaml")
    for flag, value in (("--lr", "2e-4"), ("--epochs", "60"), ("--optimizer", "adamw"),
                        ("--seed", "3"), ("-j", "4"), ("-p", "20")):
        assert argv[argv.index(flag) + 1] == value, flag
