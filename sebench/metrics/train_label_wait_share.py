"""Share of the window the loop waited for the estimate's PESQ labels (%):
the growth of ``EpochStats.label_wait`` over the window."""

from sebench.readers import window_share_pct


def read(bench):
    return window_share_pct(bench, "label_wait_s")
