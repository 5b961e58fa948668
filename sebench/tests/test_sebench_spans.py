"""The readers of the program's spans and counters (``sebench/spans.py``
and the seven metrics over it): None on an untraced run, a number on a
traced CPU run of their cell at tiny widths; the pad shares equal a hand
count from the pool's lengths, and the label threads' share is per
thread of the label pool."""

import time

import pytest

from sebench import harness, spans, synth

SERVING = {"params": {"utterances": 6, "batch_size": 4, "median_s": 0.6, "sigma": 0.5,
                      "min_s": 0.3, "max_s": 1.2, "warmup_jobs": 1, "warmup_rounds": 1},
           "config": {"num_channel": 8}}
TRAINING_METRICS = ["train_sync_share", "train_label_busy_share", "train_loader_busy_share",
                    "train_loader_wait_share"]
METRICS = {"cmgan-serve-single": ["serve_dispatch_share.single", "serve_pad_share.single"],
           "cmgan-serve-batch": ["serve_pad_share.batch"],
           "scpgan-train-gan": TRAINING_METRICS}


def _training():
    """Three batches an epoch; the window opens as the first epoch ends, so
    the second epoch's loader works inside it, and the labels run on the
    loop's thread (lag 0), inside the window's step."""
    training = harness.load_json(harness.ROOT / "configs" / "scpgan-64.json")["training"]
    return {"params": {"corpus_pairs": 12, "warmup_steps": 3, "compare_steps": 3},
            "config": {"num_channel": 8, "ndf": 4,
                       "training": dict(training, batch_size=4, workers=2, crop_frames=40,
                                        step_mode="two-phase")}}


def _pad_share(cell: str) -> float:
    """Wrap-pad samples over samples sent, by hand from the pool's lengths."""
    p = SERVING["params"]
    lengths = synth.lognormal_lengths(p["utterances"], p["median_s"], p["sigma"], p["min_s"],
                                      p["max_s"])
    quantum = harness.load_json(harness.ROOT / "configs" / "cmgan-64.json")["serving"][
        "bucket_samples"]
    rows = p["batch_size"] if cell == "cmgan-serve-batch" else 1
    ordered = sorted(lengths)
    sent = pad = 0
    for i in range(0, len(ordered), rows):
        chunk = ordered[i:i + rows]
        bucket = max(quantum, -(-max(chunk) // quantum) * quantum)
        sent += bucket * len(chunk)
        pad += bucket * len(chunk) - sum(chunk)
    return 100.0 * pad / sent


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", list(METRICS))
def test_readers_read_only_a_traced_run(monkeypatch, cell, trace):
    benches = []
    close = harness.Bench.close_window

    def keep(bench):
        benches.append(bench)
        return close(bench)

    monkeypatch.setattr(harness.Bench, "close_window", keep)
    overrides = _training() if cell == "scpgan-train-gan" else SERVING
    result = harness.run_cell(cell, 2**31 + 77, 0.1, trace, t0=time.perf_counter(),
                              device="cpu", overrides=overrides)
    assert result["correct"] is True, result["checks"]
    got = {name: harness.load_module("metrics", name).read(benches[0])
           for name in METRICS[cell]}
    if not trace:
        assert got == {name: None for name in METRICS[cell]}
        return
    for name, value in got.items():
        assert value is not None and 0 < value <= 100, (name, value)
        assert result["metrics"][name]["value"] == pytest.approx(value)
    if cell != "scpgan-train-gan":
        name = next(n for n in METRICS[cell] if n.startswith("serve_pad_share"))
        assert got[name] == pytest.approx(_pad_share(cell), rel=1e-12)


def test_label_busy_share_is_per_label_thread(monkeypatch):
    """In the pipelined mode two label threads score at once: their spans'
    seconds are divided by two windows, so the share stays a share."""
    benches = []
    close = harness.Bench.close_window

    def keep(bench):
        benches.append(bench)
        return close(bench)

    monkeypatch.setattr(harness.Bench, "close_window", keep)
    overrides = _training()
    overrides["config"]["training"]["step_mode"] = "pipelined"
    result = harness.run_cell("scpgan-train-gan", 2**31 + 91, 1.0, True, t0=time.perf_counter(),
                              device="cpu", overrides=overrides)
    assert result["correct"] is True, result["checks"]
    bench = benches[0]
    got = harness.load_module("metrics", "train_label_busy_share").read(bench)
    seconds = spans.span_seconds(bench, "se.train.labels")
    assert seconds is not None and 0 < got <= 100
    # each read maps the window onto the store's clock anew: a few us apart
    assert got == pytest.approx(100.0 * seconds / (2 * bench.window_s), rel=1e-3)
