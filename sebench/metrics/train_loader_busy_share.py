"""Share of the loader threads' time spent making batches (%): the
program's ``se.data.batch`` spans (loads, crops, silence checks and labels
of a batch) summed over the workers, over the window times the
configuration's ``training.workers``."""

from sebench.spans import span_share_pct


def read(bench):
    return span_share_pct(bench, "se.data.batch", bench.config["training"]["workers"])
