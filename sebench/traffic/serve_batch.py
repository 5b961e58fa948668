"""Offline enhancement of a directory, as ``cli.inference_gan`` does it:
closed loop, one client; each job is one ``Enhancer.enhance(utterances,
batch_size)`` call over the whole pool in an order drawn from the seed.
Two jobs warm up every shape (every job has the same lengths, so the same
buckets); the window runs whole jobs, and the first job that ends after
``--seconds`` closes it.

End to end: ``serve_audio_rate``, the audio seconds of the window's jobs
over the window's wall time.  Counters: the served frames of every
utterance (model FLOPs), the K1 launch shapes (traced runs), the jobs.
"""

from __future__ import annotations

import time

import torch

from sebench import serving


def run(bench) -> None:
    enhancer, init_state = serving.build(bench)
    lengths, utterances = serving.pool(bench)
    batch = bench.params["batch_size"]
    sr = bench.config["sample_rate"]
    for warm in range(bench.params["warmup_jobs"]):
        enhancer.enhance([utterances[i] for i in serving.order(bench, -1 - warm, len(lengths))],
                         batch_size=batch)
    shapes: list = []
    if bench.trace:
        serving.watch_k1(enhancer, shapes)
    bench.setup_done()

    served, audio, job = [], 0.0, 0
    start = bench.open_window()
    while True:
        job_order = serving.order(bench, job, len(lengths))
        outputs = enhancer.enhance([utterances[i] for i in job_order], batch_size=batch)
        served.append((job_order, outputs))
        audio += sum(lengths) / sr
        job += 1
        if time.perf_counter() - start >= bench.seconds:
            break
    window = bench.close_window()
    bench.e2e["serve_audio_rate"] = audio / window
    bench.attempted = job * len(lengths)
    bench.counters.update(jobs=job, k1_shapes=shapes,
                          served_frames=serving.served_frames(lengths, bench.config["hop"]) * job)

    del enhancer
    if bench.cuda:
        torch.cuda.empty_cache()
    serving.check(bench, init_state, utterances, served, batch)
