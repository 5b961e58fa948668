"""The port's spans and counters (speech_enhancement_tpu_torch/utils/
profiling.py and the layers that open them) on the CPU at tiny widths:

* off (no profiler session), ``span`` is one shared object and a whole
  ``Enhancer.enhance`` or ``run_gan_epoch`` stores nothing;
* under a session, spans nest with their parents, ids and threads, on
  plain threads too, at the times of their profiler events;
* the Enhancer's, the GAN loop's, the label thread's, the loader's and the
  PESQ engine's spans and counters come once per call, batch or step,
  and ``enhance.pad_samples`` and ``pesq.rows`` equal hand counts;
* the switch is torch's process-wide profiler flag;
* two sessions in one process each read their own records, and
  ``trace`` empties the store as it starts and writes the spans of
  threads the profiler does not record and the counters.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_train_common import B

from speech_enhancement_tpu_torch.data import (
    Batch,
    Collator,
    DataLoader,
    VoicebankDataset,
    save_wav,
)
from speech_enhancement_tpu_torch.enhance import Enhancer, round_to_bucket
from speech_enhancement_tpu_torch.metrics import pesq as pesq_module
from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
from speech_enhancement_tpu_torch.train import create_gan_state, l2_loss, run_gan_epoch
from speech_enhancement_tpu_torch.utils import profiling

torch.set_num_threads(1)

QUANTUM = 4000


@pytest.fixture(autouse=True)
def _empty_store():
    profiling.clear()
    yield
    profiling.clear()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return collections.Counter(s.name for s in spans)


@pytest.fixture(scope="module")
def enhancer():
    model = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(0))
    return Enhancer(model, quantum=QUANTUM, device="cpu")


@pytest.fixture(scope="module")
def utterances():
    rng = np.random.default_rng(3)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (3000, 5200, 4100)]


def _tone_batches(n, rows=B, length=4000):
    rng = np.random.default_rng(0)
    t = np.arange(length) / 16000.0
    out = []
    for i in range(n):
        tone = 0.3 * np.sin(2 * np.pi * (180 + 25 * i) * t) * (0.5 + 0.5 * np.sin(6 * np.pi * t))
        clean = np.stack([tone * (1.0 + 0.1 * j) for j in range(rows)]).astype(np.float32)
        noisy = (clean + 0.03 * rng.standard_normal((rows, length))).astype(np.float32)
        out.append(Batch(clean, noisy, np.full(rows, 1.04, np.float32),
                         rng.uniform(0.2, 0.6, rows).astype(np.float32)))
    return out


def _state():
    gen = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(0))
    disc = Discriminator(4, device="cpu", generator=torch.Generator().manual_seed(1))
    return create_gan_state(gen, disc, "sgd", 1e-3)


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Four pairs of 1.2 s tone-plus-noise wavs."""
    root = tmp_path_factory.mktemp("tracing_wavs")
    clean_dir, noisy_dir = root / "clean", root / "noisy"
    clean_dir.mkdir()
    noisy_dir.mkdir()
    rng = np.random.default_rng(1)
    t = np.arange(19200) / 16000
    for i in range(4):
        clean = (0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(np.float32)
        save_wav(clean_dir / f"p{i:03d}.wav", clean)
        save_wav(noisy_dir / f"p{i:03d}.wav",
                 clean + 0.05 * rng.standard_normal(len(t)).astype(np.float32))
    return str(clean_dir), str(noisy_dir)


def test_off_span_is_shared_and_count_stores_nothing():
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b", 3)
    with profiling.span("a"):
        profiling.count("c", 2)
    assert profiling.spans() == [] and profiling.counts() == []


def test_off_enhance_stores_nothing(enhancer, utterances):
    enhancer.enhance(utterances, batch_size=2)
    assert profiling.spans() == [] and profiling.counts() == []


def test_off_gan_epoch_stores_nothing(wav_dirs):
    loader = DataLoader(VoicebankDataset(*wav_dirs, 100, 40), 2,
                        Collator(100, 40, precompute_labels=True), seed=0, num_workers=2)
    stats = run_gan_epoch(_state(), loader, epoch=0, seed=1, criterion=l2_loss,
                          step_mode="pipelined")
    assert len(stats.gen_losses) == 2
    assert profiling.spans() == [] and profiling.counts() == []


def test_spans_nest_with_parents_ids_and_threads():
    def worker():
        assert not torch.autograd._profiler_enabled()  # the profiler skips this thread
        with profiling.span("w.outer", 7):
            with profiling.span("w.inner"):
                profiling.count("w.count", 3)

    with _session():
        with profiling.span("m.outer", "req"):
            with profiling.span("m.inner", 1):
                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=30)
    assert not thread.is_alive()
    got = {s.name: s for s in profiling.spans()}
    assert set(got) == {"m.outer", "m.inner", "w.outer", "w.inner"}
    assert got["m.outer"].parent is None and got["m.inner"].parent == got["m.outer"].seq
    assert got["w.outer"].parent is None and got["w.inner"].parent == got["w.outer"].seq
    assert (got["m.outer"].id, got["m.inner"].id, got["w.outer"].id) == ("req", 1, 7)
    assert got["m.outer"].thread == got["m.inner"].thread == threading.get_native_id()
    assert got["w.outer"].thread == got["w.inner"].thread != got["m.outer"].thread
    for outer, inner in (("m.outer", "m.inner"), ("w.outer", "w.inner"), ("m.inner", "w.outer")):
        assert got[outer].start <= got[inner].start <= got[inner].end <= got[outer].end
    assert [(c.name, c.n) for c in profiling.counts()] == [("w.count", 3)]


def test_stored_times_match_the_profiler_events():
    x = torch.randn(32, 32)
    with _session() as prof:
        for i in range(5):
            with profiling.span("t.span", i):
                (x @ x).sum()
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "t.span"),
                    key=lambda e: e.start_ns())
    stored = sorted(profiling.spans(), key=lambda s: s.start)
    assert len(events) == len(stored) == 5
    for e, s in zip(events, stored):
        assert abs(e.start_ns() - s.start) < 1_000_000
        assert abs(e.end_ns() - s.end) < 1_000_000


def test_enhance_spans_per_call_and_batch_and_pad_count(enhancer, utterances):
    with _session():
        enhancer.enhance(utterances, batch_size=2)
        enhancer.enhance(utterances[:1], batch_size=2)
    spans = profiling.spans()
    calls = [s for s in spans if s.name == "se.enhance"]
    assert len(calls) == 2 and calls[1].id == calls[0].id + 1
    batches = 2 + 1
    names = _names(spans)
    for name in ("se.enhance.bucket", "se.enhance.h2d", "se.enhance.dispatch",
                 "se.enhance.collect"):
        assert names[name] == batches, name
    # one forward of the model a batch, through each of its blocks
    assert (names["se.model.encoder"], names["se.model.tscb.time"],
            names["se.model.tscb.freq"], names["se.model.decoders"]) == (3, 12, 12, 3)
    by_seq = {s.seq: s for s in spans}
    for s in spans:
        if s.name.startswith("se.enhance."):
            assert by_seq[s.parent].name == "se.enhance", s.name
    lengths = [len(u) for u in utterances]
    sent = pad = 0
    for chunk in (sorted(lengths)[:2], sorted(lengths)[2:], lengths[:1]):
        bucket = round_to_bucket(max(chunk), QUANTUM, 100)
        sent += bucket * len(chunk)
        pad += bucket * len(chunk) - sum(chunk)
    totals = collections.defaultdict(float)
    for c in profiling.counts():
        totals[c.name] += c.n
    assert totals == {"enhance.batch_samples": sent, "enhance.pad_samples": pad}


def test_model_spans_recompute_in_the_backward():
    gen = TSCNet(8, 201, device="cpu", generator=torch.Generator().manual_seed(0)).train()
    spec = torch.randn(1, 21, 201, dtype=torch.complex64)
    with _session():
        re, im = gen(spec)
        with profiling.span("t.backward"):
            (re.square().mean() + im.square().mean()).backward()
    names = _names(profiling.spans())
    # each TSCB's forward runs again in the backward (rematerialized)
    assert (names["se.model.encoder"], names["se.model.decoders"]) == (1, 1)
    assert names["se.model.tscb.time"] == names["se.model.tscb.freq"] == 8


@pytest.mark.parametrize("step_mode", ["two-phase", "async", "pipelined"])
def test_epoch_steps_labels_and_label_wait(step_mode):
    steps = 4
    with _session():
        stats = run_gan_epoch(_state(), _tone_batches(steps), epoch=2, seed=1,
                              criterion=l2_loss, step_mode=step_mode)
    spans = profiling.spans()
    names = _names(spans)
    main = threading.get_native_id()
    step_spans = [s for s in spans if s.name == "se.train.step"]
    assert [s.id for s in step_spans] == [(2, i) for i in range(steps)]
    assert all(s.thread == main for s in step_spans)
    labels = [s for s in spans if s.name == "se.train.labels"]
    assert sorted(s.id for s in labels) == [(2, i) for i in range(stats.gan_steps)]
    # a deferred mode scores on the label pool's thread, two-phase in the loop
    assert stats.gan_steps == steps
    assert all((s.thread == main) == (step_mode == "two-phase") for s in labels)
    assert names["se.train.gen_step"] == names["se.train.gen_backward"] == steps
    assert names["se.train.disc_step"] == steps  # deferred ones in the end-of-epoch flush
    assert names["se.train.disc_backward"] == 3 * steps  # scp: three gradient passes
    assert names["se.train.optim"] == 2 * steps
    assert names["se.train.h2d"] == steps
    assert names["se.train.sync"] == 2 * steps  # each generator and discriminator loss
    assert names["se.pesq"] == steps
    waited = sum(s.end - s.start for s in spans if s.name == "se.train.label_wait") * 1e-9
    assert names["se.train.label_wait"] == steps
    assert waited == pytest.approx(stats.label_wait, abs=1e-3)


@pytest.mark.parametrize("arch, passes", [("scp", 3), ("cmgan", 1)])
def test_gan_step_spans_nest_in_their_steps(arch, passes):
    with _session():
        run_gan_epoch(_state(), _tone_batches(1), epoch=0, seed=1, criterion=l2_loss,
                      step_mode="two-phase", arch=arch)
    spans = profiling.spans()
    by_seq = {s.seq: s for s in spans}
    parents = collections.defaultdict(list)
    for s in spans:
        parents[s.name].append(by_seq[s.parent].name if s.parent is not None else None)
    assert parents["se.train.step"] == [None]
    assert parents["se.train.gen_step"] == ["se.train.step"]
    assert parents["se.train.gen_backward"] == ["se.train.gen_step"]
    assert parents["se.train.disc_backward"] == ["se.train.disc_step"] * passes
    assert sorted(parents["se.train.optim"]) == ["se.train.disc_step", "se.train.gen_step"]
    assert sorted(parents["se.train.sync"]) == ["se.train.disc_step", "se.train.step"]
    assert parents["se.train.labels"] == ["se.train.label_wait"]
    assert parents["se.model.encoder"] == ["se.train.gen_step"]


def test_tracing_follows_the_session():
    assert not profiling.tracing()
    with _session():
        assert profiling.tracing()
        held = profiling.span("held")
        held.__enter__()
    assert not profiling.tracing()
    held.__exit__(None, None, None)  # opened while on: stored
    assert [s.name for s in profiling.spans()] == ["held"]


def test_switch_is_the_process_wide_profiler_flag():
    """The switch torch keeps for every thread: a torch that renames it
    fails here first (``span`` would fall back to the calling thread's
    flag, blind to plain threads)."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    seen = []

    def look():
        seen.append((profiling.tracing(), torch.autograd.profiler._is_profiler_enabled))

    look()
    with _session():
        look()
        worker = threading.Thread(target=look)
        worker.start()
        worker.join()
    look()
    assert seen == [(False, False), (True, True), (True, True), (False, False)]


def test_loader_spans_on_workers_and_pesq_rows(monkeypatch, wav_dirs):
    collator = Collator(100, 40, precompute_labels=True)
    loader = DataLoader(VoicebankDataset(*wav_dirs, 100, 40), 2, collator, seed=0, num_workers=2)
    scored = []
    real = pesq_module.build

    def counting_build():
        lib = real()

        class Counted:
            def pesq_mos(self, *args):
                scored.append(1)
                return lib.pesq_mos(*args)

            def pesq_batch(self, clean, noisy, b, *args):
                scored.append(b)
                return lib.pesq_batch(clean, noisy, b, *args)

        return Counted()

    monkeypatch.setattr(pesq_module, "build", counting_build)
    with _session():
        got = list(loader)
    spans = profiling.spans()
    main = threading.get_native_id()
    batches = [s for s in spans if s.name == "se.data.batch"]
    assert sorted(s.id for s in batches) == list(range(len(got))) == [0, 1]
    assert all(s.thread != main for s in batches)
    by_seq = {s.seq: s for s in spans}
    reads = [s for s in spans if s.name == "se.data.read"]
    assert len(reads) == 2 and all(by_seq[s.parent].name == "se.data.batch" for s in reads)
    waits = [s for s in spans if s.name == "se.data.wait"]
    assert [s.id for s in waits] == [0, 1] and all(s.thread == main for s in waits)
    rows = sum(c.n for c in profiling.counts() if c.name == "pesq.rows")
    assert rows == sum(scored) > 0
    assert _names(spans)["se.pesq"] == len(scored)


def test_two_sessions_read_their_own_records():
    windows = []
    for name in ("first", "second"):
        start = time.time_ns()
        with _session():
            with profiling.span(name):
                profiling.count(name, 1)
        windows.append((start, time.time_ns()))
        with profiling.span("between"):  # off: not stored
            pass
    for name, window in zip(("first", "second"), windows):
        assert [s.name for s in profiling.spans(*window)] == [name]
        assert [c.name for c in profiling.counts(*window)] == [name]
    profiling.clear()
    assert profiling.spans() == [] and profiling.counts() == []


def test_trace_file_holds_worker_spans(tmp_path, wav_dirs):
    loader = DataLoader(VoicebankDataset(*wav_dirs, 100, 40), 2,
                        Collator(100, 40, silence_check=False), seed=0, num_workers=2)
    with profiling.trace(str(tmp_path)):
        with profiling.span("main.work"):
            batches = list(loader)
    assert len(batches) == 2
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    (main,) = [e for e in events if e["name"] == "main.work"]
    workers = [e for e in events if e["name"] == "se.data.batch"]
    assert len(workers) == 2 and all(e["tid"] != main["tid"] for e in workers)
    named = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    stored = {s.seq: s for s in profiling.spans() if s.name == "se.data.batch"}
    for e in workers:
        assert main["ts"] <= e["ts"] and e["ts"] + e["dur"] <= main["ts"] + main["dur"]
        s = stored[e["args"]["seq"]]
        assert abs(base + e["ts"] * 1e3 - s.start) < 1e4
        assert named[e["tid"]]


def test_trace_empties_the_store_and_writes_counters(tmp_path):
    with _session():
        profiling.count("before", 1)
    assert [c.name for c in profiling.counts()] == ["before"]
    with profiling.trace(str(tmp_path)):
        assert profiling.counts() == []
        profiling.count("rows", 2)
        worker = threading.Thread(target=profiling.count, args=("rows", 3))
        worker.start()
        worker.join()
        profiling.count("rows", 1)
    (path,) = tmp_path.glob("*.pt.trace.json")
    doc = json.loads(path.read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    track = [e for e in doc["traceEvents"] if e.get("ph") == "C"]
    assert [e["name"] for e in track] == ["rows"] * 3
    assert [e["args"]["total"] for e in track] == [2, 5, 6]
    stored = profiling.counts()
    assert [c.n for c in stored] == [2, 3, 1]
    for e, c in zip(track, stored):
        assert abs(base + e["ts"] * 1e3 - c.t) < 1e4
