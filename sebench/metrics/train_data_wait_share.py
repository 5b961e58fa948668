"""Share of the window the loop waited on the data loader's next batch (%):
the benchmark's own span around each ``next()`` of the iterable it hands
to ``run_gan_epoch``."""

from sebench.readers import window_share_pct


def read(bench):
    return window_share_pct(bench, "data_wait_s")
