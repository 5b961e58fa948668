"""K1 (fp32, 3xTF32) device time against its roofline bound (%)."""

from sebench.readers import k1_roofline_pct


def read(bench):
    return k1_roofline_pct(bench)
