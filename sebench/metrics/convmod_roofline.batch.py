"""The conformers' conv-module kernel (``csrc/conv_module.cu``: GLU,
depthwise conv, BatchNorm and swish) against its bandwidth bound (%): the
least bytes of its launches in the window (the program's counter
``convmod.bytes``: the pointwise conv's output read once, the kernel's
output written once) over the card's bandwidth, over the kernel's device
time in the trace.  None where the program has no such counter (a commit
before the kernel), no trace, or the trace's launches of the kernel differ
from the counter ``convmod.launches``."""

from sebench import spans

KERNEL = "glu_conv_swish_kernel"  # every instance's name holds it


def read(bench):
    s = bench.summary
    if s is None or bench.peaks is None:
        return None
    nbytes = spans.count_total(bench, "convmod.bytes")
    launches = spans.count_total(bench, "convmod.launches")
    if not nbytes or not launches:
        return None
    names = [n for n in s.kernel_s if KERNEL in n]
    if sum(s.kernel_count.get(n, 0) for n in names) != launches:
        return None  # the bytes would not be the launches'
    return 100.0 * nbytes / bench.peaks["bytes"] / sum(s.kernel_s[n] for n in names)
