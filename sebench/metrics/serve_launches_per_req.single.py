"""Kernel launches on the device per request in the traced window."""


def read(bench):
    s, requests = bench.summary, bench.counters.get("requests")
    if s is None or not requests or not s.kernel_launches:
        return None
    return s.kernel_launches / requests
