"""The port's checkpoint writes and its full-recipe script
(speech_enhancement_tpu_torch/utils/checkpoint.py and
scripts/run_full_recipe_proxy.py) on the CPU:

* ``save_checkpoint`` renames each directory into place whole: a
  ``torch.save`` that raises partway leaves no ``state.pt``,
  ``variables.pt`` or ``model_best`` under its final name (an older
  directory of that name stays as it was), and a later save and load
  round-trip as before;
* ``_train_cmd``'s ``main_gan`` arguments equal the JAX script's (read
  from its ``-c`` code), apart from the module, the config path and
  ``--device``;
* chip_smoke.py's phase 14 counts the kernel launches of the scripts'
  children (``-c`` and ``-m``) from their counters at exit, and a
  SIGKILLed child adds none;
* the drill runs end to end with ``--device cpu`` on a tiny corpus, the
  child's models cut to ``TSCNet(8, 201)`` and ``Discriminator(4)`` and its
  crops to 40 frames inside its ``-c`` code: a real SIGKILL after epoch 0,
  the resume at epoch 1, every checkpoint loadable, and the JAX script's
  record keys.
"""

import ast
import importlib
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import types
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.cli import inference_gan
from speech_enhancement_tpu_torch.models import TSCNet
from speech_enhancement_tpu_torch.scripts import run_full_recipe_proxy as rfp
from speech_enhancement_tpu_torch.utils import (
    checkpoint,
    latest_checkpoint,
    load_checkpoint,
    load_variables,
    save_checkpoint,
    sweep_checkpoints,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    """``scripts/<name>.py`` with the JAX compilation-cache settings it sets
    at import restored afterwards."""
    old_cache = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    module = importlib.import_module(f"scripts.{name}")
    jax.config.update("jax_compilation_cache_dir", old_cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)
    return module


class Interrupted(Exception):
    pass


@pytest.mark.parametrize("fail_on", [1, 2])  # state.pt, then variables.pt
def test_save_interrupted_partway_leaves_no_torn_file(tmp_path, monkeypatch, fail_on):
    state = {"w": torch.arange(4.0), "step": 3}
    variables = {"gen": {"w": torch.ones(2)}}
    save_checkpoint(state, str(tmp_path), 0, is_best=True, variables=variables)
    real_save, calls = torch.save, []

    def save_then_fail(obj, f, *a, **kw):
        calls.append(f)
        if len(calls) == fail_on:
            with open(f, "wb") as fh:
                fh.write(b"torn")  # a partial write
            raise Interrupted
        return real_save(obj, f, *a, **kw)

    monkeypatch.setattr(checkpoint.torch, "save", save_then_fail)
    for epoch in (1, 0):  # a new epoch, then over an existing one
        calls.clear()
        with pytest.raises(Interrupted):
            save_checkpoint({"step": 9}, str(tmp_path), epoch, is_best=True,
                            variables={"gen": {}})
    monkeypatch.setattr(checkpoint.torch, "save", real_save)

    # no final name holds the torn write; epoch 0 and model_best are as saved
    assert sorted(n for n in os.listdir(tmp_path) if not n.startswith(".")) == [
        "checkpoint_0000", "model_best"]
    assert [n for n in os.listdir(tmp_path) if n.startswith(".")] == []
    for name in ("checkpoint_0000", "model_best"):
        assert sorted(os.listdir(tmp_path / name)) == ["state.pt", "variables.pt"]
        got = load_checkpoint(str(tmp_path / name))
        assert torch.equal(got["w"], state["w"]) and got["step"] == 3
        assert torch.equal(load_variables(str(tmp_path / name))["gen"]["w"], torch.ones(2))
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_0000")

    # a later save and load round trip as before
    p = save_checkpoint({"step": 10}, str(tmp_path), 1, is_best=True, variables=variables)
    assert p.endswith("checkpoint_0001") and load_checkpoint(p)["step"] == 10
    assert load_checkpoint(str(tmp_path / "model_best"))["step"] == 10
    assert [e for e, _ in sweep_checkpoints(str(tmp_path))] == [0, 1]
    assert latest_checkpoint(str(tmp_path)) == p


def test_a_leftover_staging_directory_is_invisible(tmp_path):
    """What a process killed mid-save leaves (a hidden staging directory)
    is matched by neither ``latest_checkpoint`` nor the sweep."""
    save_checkpoint({"step": 1}, str(tmp_path), 0, variables={})
    os.makedirs(tmp_path / ".checkpoint_0001.abc123")
    torch.save({"step": 2}, tmp_path / ".checkpoint_0001.abc123" / "state.pt")
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_0000")
    assert [e for e, _ in sweep_checkpoints(str(tmp_path))] == [0]


def cli_list(code: str) -> list:
    """The argument list of the ``main_gan.main([...])`` call in ``code``."""
    return ast.literal_eval(re.search(r"main_gan\.main\((\[.*\])\)", code, re.S).group(1))


@pytest.mark.parametrize("fused, resume, precision", [
    (True, False, "bf16"), (True, True, "bf16"), (False, True, "fp32")])
def test_train_cmd_arguments_equal_jax(tmp_path, fused, resume, precision):
    jax_rfp = jax_script("run_full_recipe_proxy")
    args = Namespace(root=str(tmp_path), epochs=100, batch_size=8, train_seed=3,
                     precision=precision, fused_attention=fused, device="cpu")
    out = str(tmp_path / "run")
    want = jax_rfp._train_cmd(args, out, resume)
    got = rfp._train_cmd(args, out, resume)
    assert got[:2] == want[:2] == [want[0], "-c"]
    assert "speech_enhancement_tpu.cli import main_gan" in want[2]
    assert "speech_enhancement_tpu_torch.cli import main_gan" in got[2]
    assert "jax" not in got[2]
    want_args, got_args = cli_list(want[2]), cli_list(got[2])
    at = got_args.index("--device")
    assert got_args[at + 1] == "cpu" and at < got_args.index("--opts")
    del got_args[at:at + 2]
    cfg = got_args.index("--cfg") + 1
    assert got_args[cfg] == os.path.join(rfp.CONFIG_DIR, "scp.yaml")
    assert want_args[cfg] == "speech_enhancement_tpu/config/scp.yaml"
    got_args[cfg] = want_args[cfg]
    assert got_args == want_args
    # without --device the child gets none: the CLI's default, the card
    args.device = None
    assert "--device" not in cli_list(rfp._train_cmd(args, out, resume)[2])


# the child's models and crops, cut inside its -c code (the CLI has no
# width flag): widths 8 and 4, crops of 40 frames, as tests/test_torch_cli.py
SMALL_MODELS = (
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from speech_enhancement_tpu_torch.cli import main_gan\n"
    "from speech_enhancement_tpu_torch.models import Discriminator, TSCNet\n"
    "main_gan.TSCNet = lambda c, f, **kw: TSCNet(8, f, **kw)\n"
    "main_gan.Discriminator = lambda n, **kw: Discriminator(4, **kw)\n"
    "_main = main_gan.main\n"
    "main_gan.main = lambda argv: _main(argv + ['CROP_FRAMES', '40'])\n"
)


def test_drill_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    real_cmd = rfp._train_cmd

    def small_cmd(args, out, resume):
        exe, flag, code = real_cmd(args, out, resume)
        return [exe, flag, SMALL_MODELS + code]

    monkeypatch.setattr(rfp, "_train_cmd", small_cmd)
    monkeypatch.setattr(inference_gan, "TSCNet",
                        lambda num_channel, num_features, **kw: TSCNet(8, num_features, **kw))
    root = tmp_path / "full"
    rc = rfp.main(["--root", str(root), "--train-pairs", "4", "--test-pairs", "2",
                   "--seconds", "0.5", "--epochs", "4", "--kill-after-epoch", "0",
                   "--batch-size", "2", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert rc in (0, 1) and f"RESULT: {'PASS' if rc == 0 else 'FAIL'}" in printed
    assert re.search(r"killed trainer \d+s in, after checkpoint_0000", printed)
    assert "finished before the kill fired" not in printed

    ckpt_dir = root / "run" / "scp" / "default"
    log = (ckpt_dir / "log_rank0.txt").read_text()
    # the killed child saved epoch 0 only; the resumed one started at 1
    resumed_at = log.index("=> resumed from")
    assert "=> saved checkpoint_0000 " in log[:resumed_at]
    assert "=> saved checkpoint_0001 " not in log[:resumed_at]
    assert re.search(r"resumed from \S+checkpoint_0000 \(epoch 1\)", log)
    for epoch in range(4):
        path = str(ckpt_dir / f"checkpoint_{epoch:04d}")
        assert load_checkpoint(path)["epoch"] == epoch + 1
        assert set(load_variables(path)) == {"gen", "disc"}

    record = json.loads((root / "full_recipe_run.json").read_text())
    assert sorted(record) == sorted(["epochs", "precision", "kill_after_epoch",
                                     "resume_epoch", "best_epochs", "wall_seconds",
                                     "noisy", "per_epoch"])
    assert record["epochs"] == 4 and record["precision"] == "bf16"
    assert record["kill_after_epoch"] == 0 and record["resume_epoch"] == 1
    assert record["best_epochs"] and record["best_epochs"][0] == 0
    assert sorted(record["per_epoch"]) == ["0", "1", "2", "3"]
    for row in [record["noisy"], *record["per_epoch"].values()]:
        assert len(row) == 6 and np.isfinite(row).all()
    text = (root / "full_recipe_run.md").read_text()
    assert "on the CPU (bf16, fused attention" in text
    assert "restarted at epoch 1, the first epoch of cycle 2" in text
    assert "| epoch 3 |" in text


def test_chip_smoke_counts_the_childrens_launches(tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    script = types.SimpleNamespace(subprocess=subprocess)  # a script module's view
    with chip_smoke.children_counted(script, str(tmp_path / "counts")) as children:
        assert script.subprocess is children
        code = ("from speech_enhancement_tpu_torch.ops import _native\n"
                "_native.launches['shaw_attention_fwd_tensor_core'] += 3\n"
                "_native.launches['shaw_attention_bwd_tensor_core'] += 2\n")
        assert script.subprocess.run([sys.executable, "-c", code], cwd=REPO).returncode == 0
        helped = script.subprocess.run(
            [sys.executable, "-m", "speech_enhancement_tpu_torch.scripts.label_bias_study",
             "--help"], cwd=REPO, capture_output=True, text=True)
        assert helped.returncode == 0 and "--epochs" in helped.stdout
        killed = script.subprocess.Popen([sys.executable, "-c", "import time\ntime.sleep(60)"],
                                         cwd=REPO)
        killed.send_signal(signal.SIGKILL)
        assert killed.wait() == -signal.SIGKILL
        got = children.launches()
    assert script.subprocess is subprocess
    assert got["shaw_attention_fwd_tensor_core"] == 3
    assert got["shaw_attention_bwd_tensor_core"] == 2
    assert sum(got.values()) == 5 and len(os.listdir(tmp_path / "counts")) == 2
