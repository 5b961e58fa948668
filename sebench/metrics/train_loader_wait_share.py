"""Share of the window the training loop waited on the data loader's
worker queue (%): the program's ``se.data.wait`` spans, the inside twin of
``train_data_wait_share``."""

from sebench.spans import span_share_pct


def read(bench):
    return span_share_pct(bench, "se.data.wait")
