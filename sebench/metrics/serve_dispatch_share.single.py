"""Share of the window the Enhancer spent enqueueing its batches on the
device (%): the program's ``se.enhance.dispatch`` spans (featurization, model
and the pinned output copy enqueued)."""

from sebench.spans import span_share_pct


def read(bench):
    return span_share_pct(bench, "se.enhance.dispatch")
