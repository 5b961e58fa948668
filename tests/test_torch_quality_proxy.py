"""The port's GAN quality scripts (speech_enhancement_tpu_torch/scripts/
train_quality_proxy.py and arch_ab_rich.py) against the JAX scripts of the
same names, on the CPU.

* ``make_corpus`` writes the JAX script's bytes for rng 7, pink and rich,
  at 8 + 4 pairs of 0.5 s (the size of tests/test_quality_proxy.py's rich
  corpus), and ``corpus_digest`` of the two trees is one digest;
  chip_smoke.py's phase-13 digest is the JAX corpus's at its flags;
* ``write_proxy_report`` writes byte-equal markdown and JSON and returns
  the same exit codes as the JAX writer on the same rows, and both raise
  on an empty sweep;
* the GAN proxy runs end to end with ``--device cpu`` on a tiny corpus,
  with the CLIs' models cut to ``TSCNet(8, 201)`` and ``Discriminator(4)``
  (as tests/test_torch_cli.py cuts them): a report, a record and a sweep
  row per epoch;
* ``arch_ab_rich``'s summary (``.md`` and ``.json``) is byte-equal to the
  JAX script's on the same nine pre-written arm records (no arm trains),
  and a missing arm runs as the JAX script's subprocess with its flags;
* every script raises on a host without a card unless given ``--device
  cpu``, before it writes anything.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.cli import inference_gan, main_gan
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.scripts import arch_ab_rich
from speech_enhancement_tpu_torch.scripts import train_quality_proxy as tqp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY = re.compile(r"Best epoch (\d+): PESQ ([\d.]+) vs noisy ([\d.]+) "
                     r"\(Δ ([+-][\d.]+)\); STOI ([\d.]+) vs ([\d.]+) \(Δ ([+-][\d.]+)\)")


def jax_script(name):
    """``scripts/<name>.py``, imported with the JAX compilation-cache
    settings it sets at import restored afterwards, as
    tests/test_quality_proxy.py imports it."""
    old_cache = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    module = importlib.import_module(f"scripts.{name}")
    jax.config.update("jax_compilation_cache_dir", old_cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
    return module


def tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("corpus", ["pink", "rich"])
def test_corpus_bytes_equal_jax(tmp_path, corpus):
    jax_tqp = jax_script("train_quality_proxy")
    jax_tqp.make_corpus(str(tmp_path / "jax"), 8, 4, 0.5, np.random.default_rng(7),
                        corpus=corpus)
    tqp.make_corpus(str(tmp_path / "port"), 8, 4, 0.5, np.random.default_rng(7),
                    corpus=corpus)
    want, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert len(got) == 24 and sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name
    assert tqp.corpus_digest(str(tmp_path / "port")) == tqp.corpus_digest(str(tmp_path / "jax"))


@pytest.mark.parametrize("family", ["pink", "white", "band", "babble"])
def test_noise_families_equal_jax(family):
    jax_tqp = jax_script("train_quality_proxy")
    want = jax_tqp.synth_noise(np.random.default_rng(1), 4001, family)
    got = tqp.synth_noise(np.random.default_rng(1), 4001, family)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert abs(float((got.astype(np.float64) ** 2).mean()) - 1.0) < 1e-3


def test_chip_smoke_corpus_digest_is_jax(tmp_path):
    """Phase 13 (b) of chip_smoke.py holds the card host's corpus to the
    digest of the JAX script's at the same flags."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    n_train, n_test, seconds = chip_smoke.QUALITY_CORPUS
    jax_script("train_quality_proxy").make_corpus(str(tmp_path), n_train, n_test, seconds,
                                                  np.random.default_rng(7), corpus="rich")
    assert tqp.corpus_digest(str(tmp_path)) == chip_smoke.QUALITY_CORPUS_SHA256


BASE = np.array([2.5, 1.0, 2.7, 1.0, 0.6, 0.80])
ROWS = [(0, np.array([1.4, 1.0, 1.6, 1.0, -6.7, 0.55])),
        (9, np.array([3.1, 1.0, 2.9, 1.1, 1.9, 0.86]))]


@pytest.mark.parametrize("rows, label, per_key, require_stoi, rc", [
    (ROWS, "epoch", "per_epoch", True, 0),  # epoch 9 beats noisy on PESQ and STOI
    (ROWS[:1], "step", "per_step", False, 1),  # the best row below noisy: FAIL
    ([(3, np.array([2.6, 1.0, 2.7, 1.0, 0.6, 0.79]))], "epoch", "per_epoch", True, 1),
])
def test_write_proxy_report_equals_jax(tmp_path, rows, label, per_key, require_stoi, rc):
    jax_tqp = jax_script("train_quality_proxy")
    outs = {}
    for side, writer in (("jax", jax_tqp.write_proxy_report), ("port", tqp.write_proxy_report)):
        report, record = tmp_path / side / "run.md", tmp_path / side / "rec.json"
        code = writer(str(report), ["# Title", "", "a line"], BASE, rows, label, str(record),
                      {"arch": "scp", "seed": 3}, per_key, require_stoi=require_stoi)
        outs[side] = (code, report.read_bytes(), record.read_bytes())
    assert outs["port"] == outs["jax"] and outs["port"][0] == rc
    with pytest.raises(SystemExit):
        tqp.write_proxy_report(str(tmp_path / "empty.md"), ["# T"], BASE, [], "epoch",
                               str(tmp_path / "empty.json"), {}, "per_epoch")
    assert not (tmp_path / "empty.md").exists()


@pytest.fixture
def small_gan(monkeypatch):
    for module in (main_gan, inference_gan):
        monkeypatch.setattr(module, "TSCNet",
                            lambda num_channel, num_features, **kw: TSCNet(8, num_features, **kw))
    monkeypatch.setattr(main_gan, "Discriminator", lambda ndf, **kw: Discriminator(4, **kw))


def test_gan_proxy_end_to_end_on_cpu(tmp_path, small_gan, capsys):
    root = tmp_path / "proxy"
    rc = tqp.main(["--root", str(root), "--train-pairs", "4", "--test-pairs", "2",
                   "--seconds", "1", "--epochs", "1", "--batch-size", "2", "--corpus", "rich",
                   "--precision", "bf16", "--fused-attention", "--step-mode", "async",
                   "--train-seed", "4", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert rc in (0, 1) and f"RESULT: {'PASS' if rc == 0 else 'FAIL'}" in printed
    text = (root / "quality_proxy_run.md").read_text()
    assert text.startswith("# Training-to-quality proxy run (synthetic corpus)\n")
    assert "on the CPU (bf16 training)." in text
    assert "| checkpoint | PESQ | CSIG | CBAK | COVL | SSNR | STOI |" in text
    assert re.search(r"\| noisy \(baseline\) \|( -?[\d.]+ \|){6}", text)
    assert SUMMARY.search(text)
    record = json.loads((root / "ab_scp_async_rich_s4.json").read_text())
    assert record["arch"] == "scp" and record["precision"] == "bf16"
    assert record["fused_attention"] and record["step_mode"] == "async"
    assert record["corpus"] == "rich" and record["seed"] == 4 and record["epochs"] == 1
    assert sorted(record["per_epoch"]) == ["0"]
    for row in [record["noisy"], *record["per_epoch"].values()]:
        assert len(row) == 6 and np.isfinite(row).all()
    assert "| epoch 0 |" in text


def write_records(root):
    """Nine arm records in the layout train_quality_proxy writes."""
    rng = np.random.default_rng(3)
    noisy = [2.536, 1.0, 2.7, 1.05, 0.62, 0.805]
    for arch in arch_ab_rich.ARCHES:
        for seed in arch_ab_rich.SEEDS:
            path = arch_ab_rich.record_path(os.path.join(root, f"{arch}_s{seed}"), arch, seed)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            per_epoch = {str(e): [float(v) for v in 2.5 + rng.uniform(0, 1, 6)]
                         for e in range(8)}
            with open(path, "w") as f:
                json.dump({"arch": arch, "seed": seed, "noisy": noisy,
                           "per_epoch": per_epoch}, f, indent=1)


def test_arch_ab_summary_equals_jax(tmp_path, monkeypatch, capsys):
    write_records(str(tmp_path))
    assert arch_ab_rich.main(["--root", str(tmp_path), "--report",
                              str(tmp_path / "port" / "summary.md"), "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["arch_ab_rich.py", "--root", str(tmp_path), "--report",
                                      str(tmp_path / "jax" / "summary.md")])
    assert jax_script("arch_ab_rich").main() == 0
    assert "record exists, skipping" in capsys.readouterr().out
    for name in ("summary.md", "summary.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert arch_ab_rich.record_path("r", "sc", 4) == jax_script("arch_ab_rich").record_path(
        "r", "sc", 4)


SCRIPTS = ["train_quality_proxy", "check_precision_quality", "arch_ab_rich",
           "train_diffusion_proxy", "train_cdiffuse_proxy"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_needs_a_card_unless_told_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    module = importlib.import_module(f"speech_enhancement_tpu_torch.scripts.{name}")
    argv = [] if name == "check_precision_quality" else ["--root", str(tmp_path / "r")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not (tmp_path / "r").exists()


def test_arch_ab_runs_a_missing_arm_as_the_jax_script_does(tmp_path, monkeypatch):
    """A missing arm runs ``train_quality_proxy`` in a subprocess with the
    JAX script's arm flags (plus ``--device``), from the directory that
    holds the package, and its record is read back."""
    seen, real_run = {}, subprocess.run

    def run(cmd, cwd):
        seen.update(cmd=cmd, cwd=cwd)
        write_records(str(tmp_path))
        return type("Done", (), {"returncode": 0})()

    monkeypatch.setattr(arch_ab_rich.subprocess, "run", run)
    record = arch_ab_rich.run_arm(str(tmp_path), "sc", 4, 8, "cpu")
    assert record["arch"] == "sc" and record["seed"] == 4
    arm_root = str(tmp_path / "sc_s4")
    assert seen["cmd"] == [
        sys.executable, "-m", "speech_enhancement_tpu_torch.scripts.train_quality_proxy",
        "--root", arm_root, "--epochs", "8", "--arch", "sc", "--train-seed", "4",
        "--corpus", "rich", "--precision", "bf16", "--fused-attention", "--step-mode",
        "async", "--report", os.path.join(arm_root, "report.md"), "--device", "cpu"]
    assert seen["cwd"] == REPO
    help_text = real_run(seen["cmd"][:3] + ["--help"], cwd=seen["cwd"], capture_output=True,
                         text=True, timeout=120)
    assert help_text.returncode == 0 and "--train-seed" in help_text.stdout
