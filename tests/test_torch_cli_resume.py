"""``--resume auto`` and ``--init-from`` of the port's ``main_gan`` on the
CPU, on the tiny dataset and small models of tests/test_torch_cli.py.

* A run stopped right after its epoch-0 checkpoint and resumed with
  ``--resume auto`` ends with the variables of a run of 2 epochs straight
  through, bit for bit (as tests/test_cli.py::
  test_main_gan_resume_bit_exact pins for the JAX CLI): the loader, the
  schedule (the optimizers' update counts), the momentum buffers and the
  step seeds are functions of (seed, epoch) and of the checkpoint only.
* ``--init-from`` seeds the weights from a checkpoint's ``variables.pt``
  with fresh optimizers at epoch 0; together with ``--resume`` it is
  refused.
* An epoch stopped by the preemption guard saves an emergency checkpoint
  (``state.pt`` only) that resumes that epoch.
"""

import pytest
import torch
from test_torch_cli import small_models, tiny_dataset, train  # noqa: F401 (fixtures)

from speech_enhancement_tpu_torch.cli import main_gan
from speech_enhancement_tpu_torch.utils import load_checkpoint, load_variables

torch.set_num_threads(1)


def _assert_equal(a: dict, b: dict):
    for model in ("gen", "disc"):
        assert a[model].keys() == b[model].keys()
        for key, value in a[model].items():
            assert torch.equal(value, b[model][key]), (model, key)


def test_resume_auto_is_bit_exact(tiny_dataset, small_models, monkeypatch):  # noqa: F811
    root, cfg = tiny_dataset
    straight = train(cfg, root / "out_straight", "--epochs", "2")
    real_save = main_gan.save_checkpoint

    class Killed(Exception):
        pass

    def save_and_die(state, output, epoch, *args, **kwargs):
        real_save(state, output, epoch, *args, **kwargs)
        if epoch == 0:
            raise Killed

    monkeypatch.setattr(main_gan, "save_checkpoint", save_and_die)
    with pytest.raises(Killed):
        train(cfg, root / "out_killed", "--epochs", "2")
    monkeypatch.setattr(main_gan, "save_checkpoint", real_save)
    resumed = train(cfg, root / "out_killed", "--epochs", "2", "--resume", "auto")

    assert [r["epoch"] for r in resumed] == [1]
    assert resumed[0]["train"].gen_losses == straight[1]["train"].gen_losses
    assert resumed[0]["train"].disc_losses == straight[1]["train"].disc_losses
    _assert_equal(load_variables(root / "out_killed" / "scp" / "default" / "checkpoint_0001"),
                  load_variables(root / "out_straight" / "scp" / "default" / "checkpoint_0001"))


def test_init_from_loads_weights_only(tiny_dataset, small_models, monkeypatch):  # noqa: F811
    root, cfg = tiny_dataset
    train(cfg, root / "out_src", "--epochs", "1")
    src = root / "out_src" / "scp" / "default" / "checkpoint_0000"
    captured = {}
    real_epoch = main_gan.run_gan_epoch

    def spy(state, batches, **kw):
        variables = {m: {k: v.clone() for k, v in sd.items()}
                     for m, sd in state.variables().items()}
        captured.setdefault("state", (variables, state.gen_opt.count, state.epoch,
                                      state.best_loss))
        return real_epoch(state, batches, **kw)

    monkeypatch.setattr(main_gan, "run_gan_epoch", spy)
    # another seed: freshly drawn weights could not equal the source's
    main_gan.main(["-a", "scp", "--cfg", cfg, "--output", str(root / "out_dst"), "--seed",
                   "5", "-j", "2", "--device", "cpu", "--epochs", "1", "--init-from", str(src)])
    variables, count, epoch, best_loss = captured["state"]
    _assert_equal(variables, load_variables(src))
    assert (count, epoch, best_loss) == (0, 0, 1e8)  # fresh optimizers, not a resume
    assert (root / "out_dst" / "scp" / "default" / "checkpoint_0000").exists()
    with pytest.raises(SystemExit):
        train(cfg, root / "out_both", "--epochs", "1", "--init-from", str(src),
              "--resume", "auto")


def test_preemption_saves_a_resumable_checkpoint(tiny_dataset, small_models,  # noqa: F811
                                                 monkeypatch):
    root, cfg = tiny_dataset

    class StopNow(main_gan.PreemptionGuard):
        should_stop = property(lambda self: True, lambda self, value: None)

    monkeypatch.setattr(main_gan, "PreemptionGuard", StopNow)
    history = train(cfg, root / "out_preempted", "--epochs", "2")
    ckpt = root / "out_preempted" / "scp" / "default" / "checkpoint_0000"
    assert history == [] and sorted(p.name for p in ckpt.iterdir()) == ["state.pt"]
    state = load_checkpoint(ckpt)
    assert state["epoch"] == 0 and state["gen_step"] == 1  # stopped after its first step
