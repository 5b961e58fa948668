"""The port's utilities (speech_enhancement_tpu_torch/utils), after
tests/test_utils.py:23-125, on the CPU: the meters, the checkpoint round
trip and ``model_best``, the numeric latest checkpoint, the sweep with
its padded/unpadded twins and its skipped emergency saves, the preemption
guard, the logger, and the GAN train state through a checkpoint (models,
optimizers, counters) bit for bit."""

import os
import signal

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.train import (
    build_optimizer,
    create_gan_state,
    gan_generator_step,
    l2_loss,
)
from speech_enhancement_tpu_torch.utils import (
    AverageMeter,
    PreemptionGuard,
    ProgressMeter,
    create_logger,
    latest_checkpoint,
    load_checkpoint,
    load_variables,
    save_checkpoint,
    sweep_checkpoints,
)

torch.set_num_threads(1)


def test_average_meter():
    m = AverageMeter()
    m.update(1.0)
    m.update(3.0)
    assert m.avg == 2.0 and m.val == 3.0
    m.update(5.0, n=2)
    assert abs(m.avg - 3.5) < 1e-9  # (1 + 3 + 5*2) / 4
    assert str(m) == "5.0000 (3.5000)"


def test_progress_meter_prints(capsys):
    m = AverageMeter()
    m.update(0.5)
    ProgressMeter(10, [m], prefix="Epoch: [0]").display(3)
    out = capsys.readouterr().out
    assert "[ 3/10]" in out and "0.5" in out


def test_checkpoint_roundtrip_and_best(tmp_path):
    state = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}, "step": 7}
    variables = {"w": torch.ones(2)}
    p = save_checkpoint(state, str(tmp_path), 3, is_best=True, variables=variables)
    assert p.endswith("checkpoint_0003")
    assert sorted(os.listdir(p)) == ["state.pt", "variables.pt"]
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_0003")
    restored = load_checkpoint(p)
    assert torch.equal(restored["params"]["w"], state["params"]["w"]) and restored["step"] == 7
    best = os.path.join(str(tmp_path), "model_best")
    assert torch.equal(load_variables(best)["w"], torch.ones(2))
    # a later save of the same epoch replaces it; an emergency save has no variables
    save_checkpoint({"step": 8}, str(tmp_path), 3)
    assert load_checkpoint(p)["step"] == 8 and os.listdir(p) == ["state.pt"]


def test_latest_checkpoint_sorts_numerically(tmp_path):
    for name in ("checkpoint_9500", "checkpoint_10500", "checkpoint_0002", "model_best",
                 "checkpoint_tmp"):  # non-numeric: ignored
        os.makedirs(os.path.join(str(tmp_path), name))
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_10500")
    assert latest_checkpoint(str(tmp_path / "missing")) is None


def _touch(root, name, files):
    os.makedirs(os.path.join(str(root), name))
    for f in files:
        open(os.path.join(str(root), name, f), "wb").close()


def test_sweep_checkpoints(tmp_path, capsys):
    for name, files in (("checkpoint_0000", ["state.pt", "variables.pt"]),
                        ("checkpoint_0002", ["state.pt", "variables.pt"]),
                        ("checkpoint_0001", ["state.pt"]),         # emergency: skipped
                        ("checkpoint_5", ["variables.pt"]),        # unpadded foreign
                        ("checkpoint_0005", ["variables.pt"]),     # padded twin: one entry
                        ("checkpoint_7", ["variables.pt"]),        # unpadded, no twin
                        ("model_best", ["variables.pt"])):         # non-numeric: ignored
        _touch(tmp_path, name, files)
    got = sweep_checkpoints(str(tmp_path))
    assert [(e, p.name) for e, p in got] == [(0, "checkpoint_0000"), (2, "checkpoint_0002"),
                                             (5, "checkpoint_0005"), (7, "checkpoint_7")]
    assert "skipping epoch 1" in capsys.readouterr().out
    assert [e for e, _ in sweep_checkpoints(str(tmp_path), start=1, end=5)] == [2]
    assert [(e, p.name) for e, p in sweep_checkpoints(str(tmp_path), start=0, end=3)] == [
        (0, "checkpoint_0000"), (2, "checkpoint_0002")]


def test_sweep_checkpoints_prefers_restorable_twin(tmp_path):
    _touch(tmp_path, "checkpoint_0003", ["state.pt"])
    _touch(tmp_path, "checkpoint_3", ["variables.pt"])
    assert [(e, p.name) for e, p in sweep_checkpoints(str(tmp_path))] == [(3, "checkpoint_3")]


def test_preemption_guard():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    assert not guard.should_stop
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.should_stop
    guard.restore()
    assert signal.getsignal(signal.SIGTERM) is before


def test_logger_writes_once_per_run(tmp_path, capsys):
    for run in ("a", "b"):
        logger = create_logger(str(tmp_path / run), 0, "port_test_logger")
        logger.info(f"run {run}")
    out = capsys.readouterr().out
    assert out.count("run a") == 1 and out.count("run b") == 1
    assert "run b" not in (tmp_path / "a" / "log_rank0.txt").read_text()
    assert "run b" in (tmp_path / "b" / "log_rank0.txt").read_text()


def _state(seed):
    gen = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(seed))
    disc = Discriminator(4, device="cpu", generator=torch.Generator().manual_seed(seed + 1))
    return create_gan_state(gen, disc, "sgd", lambda step: 1e-3 * (1 + step))


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_state_through_a_checkpoint_is_bit_exact(tmp_path, optimizer):
    """A state saved after two steps and loaded into a fresh one takes the
    same third step, bit for bit: momentum or moments, update counts (the
    schedule), BatchNorm statistics and spectral-norm vectors all travel."""
    rng = np.random.default_rng(0)
    clean = torch.from_numpy((0.1 * rng.standard_normal((2, 4000))).astype(np.float32))
    noisy = clean + 0.02 * torch.from_numpy(rng.standard_normal((2, 4000)).astype(np.float32))
    a = _state(0)
    if optimizer == "adamw":
        a.gen_opt = build_optimizer("adamw", 1e-3, a.gen)
    for seed in (1, 2):
        gan_generator_step(a, clean, noisy, seed, criterion=l2_loss)
    a.best_loss, a.epoch = 0.5, 4
    save_checkpoint(a.state_dict(), str(tmp_path), 1, variables=a.variables())
    b = _state(9)
    if optimizer == "adamw":
        b.gen_opt = build_optimizer("adamw", 1e-3, b.gen)
    b.load_state_dict(load_checkpoint(str(tmp_path / "checkpoint_0001")))
    assert (b.gen_step, b.best_loss, b.epoch, b.gen_opt.count) == (2, 0.5, 4, 2)
    for s in (a, b):
        gan_generator_step(s, clean, noisy, 3, criterion=l2_loss)
    for x, y in ((a.gen, b.gen), (a.disc, b.disc)):
        for (key, u), v in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(u, v), key
    variables = load_variables(str(tmp_path / "checkpoint_0001"))
    assert set(variables) == {"gen", "disc"}
