"""Share of the window the training loop waited to read its losses back
to the host (%): the program's ``se.train.sync`` spans."""

from sebench.spans import span_share_pct


def read(bench):
    return span_share_pct(bench, "se.train.sync")
