"""A whole run at a tiny width on the CPU (the look for a card skipped),
sound and with the timed path broken underneath: ``correct`` is true for
the sound run and false for each fault the cell can have."""

import contextlib
import time

import pytest

from sebench import faults, harness

SERVING = {"params": {"utterances": 6, "batch_size": 4, "median_s": 0.6, "sigma": 0.5,
                      "min_s": 0.3, "max_s": 1.2, "warmup_jobs": 1, "warmup_rounds": 1},
           "config": {"num_channel": 8}}


def _training(gan_active=True):
    training = harness.load_json(harness.ROOT / "configs" / "scpgan-64.json")["training"]
    return {"params": {"corpus_pairs": 12, "warmup_steps": 4, "gan_active": gan_active},
            "config": {"num_channel": 8, "ndf": 4,
                       "training": dict(training, batch_size=4, workers=2)}}


def _run(cell, overrides, fault=None):
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        return harness.run_cell(cell, 20240601, 0.5, False, t0=time.perf_counter(),
                                device="cpu", overrides=overrides)


# a batch of one row (the single cell) has no half to leave out
@pytest.mark.parametrize("cell, fault", [
    ("cmgan-serve-batch", None), ("cmgan-serve-batch", "answer_altered"),
    ("cmgan-serve-batch", "serving_half_batch"), ("cmgan-serve-single", None),
    ("cmgan-serve-single", "answer_altered")])
def test_serving_run_is_correct_only_when_sound(cell, fault):
    result = _run(cell, SERVING, fault)
    assert result["correct"] is (fault is None), result["checks"]


# gan_active false: the generator-only epochs, which a later cell can take
@pytest.mark.parametrize("gan_active", [True, False])
@pytest.mark.parametrize("fault", [None, "state_unchanged", "training_half_batch"])
def test_training_run_is_correct_only_when_sound(gan_active, fault):
    result = _run("scpgan-train-gan", _training(gan_active), fault)
    assert result["correct"] is (fault is None), result["checks"]
