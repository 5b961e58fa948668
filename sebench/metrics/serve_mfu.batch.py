"""Model FLOPs of the served utterances over the window, as a share of the
card's TF32 peak (%)."""

from sebench.readers import serving_mfu_pct


def read(bench):
    return serving_mfu_pct(bench)
