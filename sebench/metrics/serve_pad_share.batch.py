"""Share of the samples the Enhancer sent to the device that wrap-pad
added to fill each batch's bucket (%): the program's counters
``enhance.pad_samples`` over ``enhance.batch_samples``."""

from sebench.spans import pad_share_pct


def read(bench):
    return pad_share_pct(bench)
