"""Share of the traced window with no operation on the device (%)."""

from sebench.readers import idle_pct


def read(bench):
    return idle_pct(bench)
