"""The port's PESQ validation set and conformance sweep
(speech_enhancement_tpu_torch/scripts/make_pesq_validation_set.py) against
the JAX script, on the CPU:

* the sweep's constants, ``_speech_like``, ``_mnru`` and ``build_pairs(12)``
  (every degradation kind twice) are the JAX script's bit for bit;
* the port's engine reproduces the committed
  tests/fixtures/pesq_engine_conformance.json on the subset
  tests/test_pesq.py re-scores with the JAX engine, at 1e-4, and the
  fixture's behavioural bounds hold;
* ``build_conformance`` has the JAX layout and summary on any scorer;
* ``--conformance`` writes to ``--out``, and ``--score`` exits 1 with the
  JAX message when the `pesq` package is missing.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from speech_enhancement_tpu_torch.metrics.pesq import pesq
from speech_enhancement_tpu_torch.scripts import make_pesq_validation_set as mpv

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "pesq_engine_conformance.json")


def jax_mpv():
    return importlib.import_module("scripts.make_pesq_validation_set")


def test_constants_equal_jax():
    j = jax_mpv()
    for name in ("SR", "KINDS", "MNRU_QS", "MNRU_SEEDS", "LEVEL_OFFSETS_DB", "DELAY_MS"):
        assert getattr(mpv, name) == getattr(j, name), name


@pytest.mark.parametrize("seed", [7001, 7006, 1003])
def test_generators_equal_jax(seed):
    j = jax_mpv()
    clean = mpv._speech_like(np.random.default_rng(seed))
    want = j._speech_like(np.random.default_rng(seed))
    assert clean.dtype == want.dtype == np.float64 and np.array_equal(clean, want)
    for q in (5, 25, 45):
        got = mpv._mnru(np.random.default_rng(seed * 100 + q), clean, q)
        assert np.array_equal(got, j._mnru(np.random.default_rng(seed * 100 + q), want, q))


def test_build_pairs_equal_jax():
    got, want = mpv.build_pairs(12), jax_mpv().build_pairs(12)
    assert [p["kind"] for p in got] == mpv.KINDS * 2
    for g, w in zip(got, want):
        assert (g["seed"], g["kind"], g["severity"]) == (w["seed"], w["kind"], w["severity"])
        assert np.array_equal(g["clean"], w["clean"]) and np.array_equal(g["deg"], w["deg"])


def test_port_engine_reproduces_the_committed_fixture():
    with open(FIXTURE) as f:
        data = json.load(f)
    assert data["summary"]["monotone_violations"] == 0
    assert data["summary"]["max_abs_level_delta_mos"] <= 0.02
    assert data["summary"]["max_abs_delay_delta_mos"] <= 0.05
    # the subset tests/test_pesq.py re-scores with the JAX engine
    subset = [r for r in data["mnru"] if r["seed"] == data["mnru"][0]["seed"]][::3]
    assert len(subset) == 3
    for rec in subset:
        clean = mpv._speech_like(np.random.default_rng(rec["seed"]))
        deg = mpv._mnru(np.random.default_rng(rec["seed"] * 100 + rec["q_db"]), clean,
                        rec["q_db"])
        np.testing.assert_allclose(pesq(mpv.SR, clean, deg), rec["mos"], atol=1e-4)


def test_build_conformance_layout_equals_jax():
    """Both ``build_conformance`` on one deterministic scorer (a function of the
    signals, so no engine runs): the same records and summary."""
    def score(fs, ref, deg):
        return 1.0 + 3.5 * float(np.abs(ref[:4000]).mean() /
                                 (np.abs(deg[:4000] - ref[:4000]).mean() + 0.01))

    got, want = mpv.build_conformance(score), jax_mpv().build_conformance(score)
    assert got["generator"].startswith("python -m speech_enhancement_tpu_torch.scripts.")
    del got["generator"], want["generator"]
    assert got == want
    assert len(got["mnru"]) == 54 and len(got["level_offsets"]) == 12
    assert len(got["delay_offsets"]) == 9


def test_conformance_writes_to_out_and_score_needs_pesq(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(mpv, "build_conformance",
                        lambda score_fn: {"summary": {}, "mnru_mean_curve": {}, "scorer":
                                          score_fn.__module__})
    out = tmp_path / "sub" / "conf.json"
    assert mpv.main(["--conformance", "--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["scorer"] == "speech_enhancement_tpu_torch.metrics.pesq"
    try:
        import pesq as _itu  # noqa: F401
        pytest.skip("the `pesq` package is installed here")
    except ImportError:
        pass
    capsys.readouterr()
    assert mpv.main(["--conformance", "--score", "--out", str(tmp_path / "itu.json"),
                     "--device", "cpu"]) == 1
    assert "ERROR: `pesq` package not installed." in capsys.readouterr().err
    assert not (tmp_path / "itu.json").exists()
