"""One recording enhanced while the user waits: one utterance per
``Enhancer.enhance([u], batch_size=1)`` call, back to back, closed loop,
one client.  Each round sends the whole pool in an order drawn from the
seed; one round warms up every shape (each utterance's own bucket), and
the window runs whole rounds: the first round that ends after
``--seconds`` closes it, so every window holds the pool's lengths in the
same proportion.

End to end: ``serve_p95_ms``, the 95th percentile of every request's
time from call to return.  Counters: the requests, their served frames
(model FLOPs).
"""

from __future__ import annotations

import statistics
import time

import torch

from sebench import serving


def run(bench) -> None:
    enhancer, init_state = serving.build(bench)
    lengths, utterances = serving.pool(bench)
    for warm in range(bench.params["warmup_rounds"]):
        for i in serving.order(bench, -1 - warm, len(lengths)):
            enhancer.enhance([utterances[i]], batch_size=1)
    bench.setup_done()

    served, latencies, rounds = [], [], 0
    start = bench.open_window()
    while True:
        for i in serving.order(bench, rounds, len(lengths)):
            t = time.perf_counter()
            out = enhancer.enhance([utterances[i]], batch_size=1)
            latencies.append(time.perf_counter() - t)
            served.append(([i], out))
        rounds += 1
        if time.perf_counter() - start >= bench.seconds:
            break
    bench.close_window()
    bench.e2e["serve_p95_ms"] = 1e3 * statistics.quantiles(latencies, n=100,
                                                           method="inclusive")[94]
    bench.attempted = len(latencies)
    bench.counters.update(requests=len(latencies),
                          served_frames=serving.served_frames(lengths, bench.config["hop"])
                          * rounds)

    del enhancer
    if bench.cuda:
        torch.cuda.empty_cache()
    serving.check(bench, init_state, utterances, served, 1)
