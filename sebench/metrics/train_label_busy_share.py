"""Share of the PESQ label threads' time spent busy (%): the program's
``se.train.labels`` spans (the copy wait and the PESQ of each estimate)
summed over the threads, over the window times the label pool's size
(the step mode's discriminator lag, one thread at lag 0)."""

from sebench.spans import span_share_pct
from speech_enhancement_tpu_torch.train.loop import DISC_LAG


def read(bench):
    lanes = max(1, DISC_LAG[bench.config["training"]["step_mode"]])
    return span_share_pct(bench, "se.train.labels", lanes)
