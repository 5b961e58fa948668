"""The conformers' add-and-LayerNorm kernel (``csrc/add_layer_norm.cu``)
against its bandwidth bound (%): the least bytes of its launches in the
window (the program's counter ``norm.bytes``: inputs read once, outputs
written once) over the card's bandwidth, over the kernel's device time in
the trace.  None where the program has no such counter (a commit before
the kernel), no trace, or the trace's launches of the kernel differ from
the counter ``norm.launches``."""

from sebench import spans

KERNEL = "add_layer_norm"  # every instance's name holds it


def read(bench):
    s = bench.summary
    if s is None or bench.peaks is None:
        return None
    nbytes = spans.count_total(bench, "norm.bytes")
    launches = spans.count_total(bench, "norm.launches")
    if not nbytes or not launches:
        return None
    names = [n for n in s.kernel_s if KERNEL in n]
    if sum(s.kernel_count.get(n, 0) for n in names) != launches:
        return None  # the bytes would not be the launches'
    return 100.0 * nbytes / bench.peaks["bytes"] / sum(s.kernel_s[n] for n in names)
