"""Arithmetic the per-layer metric readers share.  Each reader returns
None where its run gives it nothing to read (no trace, no peak table for
the card, no launch of its kernel), never 0."""

from __future__ import annotations

from sebench.reference import flops


def idle_pct(bench) -> float | None:
    """Share of the traced window in which no device operation ran."""
    s = bench.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def serving_mfu_pct(bench) -> float | None:
    """Model FLOPs of the window's utterances at their own lengths (rounded
    up to a hop; bucket padding not counted) over the window's seconds,
    over the TF32 peak: the Enhancer's default runs the matmuls and cuDNN
    convolutions in TF32."""
    if bench.peaks is None or not bench.counters.get("served_frames"):
        return None
    cfg = bench.config
    per_frames = flops.serving_flops_per_frames(cfg["num_channel"], cfg["num_features"])
    total = sum(per_frames(t) for t in bench.counters["served_frames"])
    return 100.0 * total / bench.window_s / bench.peaks["tf32"]


def training_mfu_pct(bench) -> float | None:
    """Model FLOPs of the window's steps (``reference/flops.py``) over the
    window's seconds, over the TF32 peak: in the fp32 step cuDNN runs the
    convolutions in TF32 (the linears run in IEEE fp32, whose lower peak
    the share would then exceed 100% against)."""
    if bench.peaks is None or not bench.counters.get("steps"):
        return None
    cfg, tr = bench.config, bench.config["training"]
    per_step = flops.training_step_flops(
        cfg["num_channel"], cfg["num_features"], cfg["ndf"], tr["batch_size"],
        cfg["hop"] * tr["crop_frames"] * tr["crop_len"], cfg["n_fft"], cfg["hop"],
        cfg["compress_power"], bench.params["gan_active"])
    return 100.0 * per_step * bench.counters["steps"] / bench.window_s / bench.peaks["tf32"]


def window_share_pct(bench, seconds_key: str) -> float | None:
    seconds = bench.counters.get(seconds_key)
    if seconds is None or bench.window_s <= 0:
        return None
    return 100.0 * seconds / bench.window_s


K1_FP32 = "shaw_attention_tf32_kernel"


def k1_roofline_pct(bench) -> float | None:
    """The fp32 K1's least time summed over its launches in the window
    (each launch's shape from ``counters['k1_shapes']``) over its device
    time in the trace."""
    s, shapes = bench.summary, bench.counters.get("k1_shapes")
    if s is None or bench.peaks is None or not shapes:
        return None
    names = [n for n in s.kernel_s if K1_FP32 in n]
    launches = sum(s.kernel_count.get(n, 0) for n in names)
    if launches != len(shapes):  # the shapes would not be the launches'
        return None
    least = sum(flops.k1_bound_s(rows, n, bench.peaks) for rows, n in shapes)
    return 100.0 * least / sum(s.kernel_s[n] for n in names)
