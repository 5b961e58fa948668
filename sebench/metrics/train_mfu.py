"""Model FLOPs of the window's training steps over the window, as a share
of the card's TF32 peak (%)."""

from sebench.readers import training_mfu_pct


def read(bench):
    return training_mfu_pct(bench)
