"""The yardstick's arithmetic: the card's peaks, a kernel's least time
(its roofline bound), K1's operations and bytes, and model FLOPs counted
by ``torch.utils.flop_counter.FlopCounterMode`` over the plain reference
models on the meta device (matmuls and convolutions, forward and
backward, whatever implements them in the program)."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from sebench.reference import dsp
from sebench.reference.models import Discriminator, TSCNet

# one H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit:
# bf16 on tensor cores, TF32 on tensor cores (which a 3xTF32 kernel spends
# three times per fp32-accurate product), fp32 on CUDA cores, HBM3
PEAKS = {"H100": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "bytes": 3.35e12}}


def peaks(kind: str) -> dict | None:
    """The peak table of a card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not know."""
    for key, table in PEAKS.items():
        if key in kind:
            return table
    return None


def bound_s(flops: float, nbytes: float, flop_rate: float, byte_rate: float) -> float:
    """Least seconds: the larger of operations over peak and bytes over
    bandwidth."""
    return max(flops / flop_rate, nbytes / byte_rate)


def k1_ops_bytes(rows: int, n: int, heads: int = 4, dim_head: int = 16,
                 elem: int = 4) -> tuple[float, float]:
    """K1 on ``rows`` sequences of ``n`` frames: three n x n x d contractions
    per (sequence, head) (q.k, q.rel, p.v); q, k, v read and the output
    written once each."""
    return (6.0 * rows * heads * n * n * dim_head,
            4.0 * rows * n * heads * dim_head * elem)


def k1_bound_s(rows: int, n: int, table: dict, heads: int = 4, dim_head: int = 16) -> float:
    """The fp32 K1's least time: three TF32 products per fp32 product."""
    flops, nbytes = k1_ops_bytes(rows, n, heads, dim_head)
    return bound_s(3 * flops, nbytes, table["tf32"], table["bytes"])


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _meta_generator(num_channel: int, num_features: int) -> TSCNet:
    with torch.device("meta"):
        return TSCNet(num_channel, num_features)


def generator_forward_flops(num_channel: int, num_features: int, frames: int) -> int:
    """TSCNet's forward on one spectrum of ``frames`` frames."""
    model = _meta_generator(num_channel, num_features).eval()
    spec = torch.empty(1, frames, num_features, device="meta")
    with torch.no_grad():
        return _count(lambda: model(spec, spec))


@functools.lru_cache(maxsize=None)
def serving_flops_per_frames(num_channel: int, num_features: int):
    """``frames -> FLOPs`` of one utterance's forward.  Every layer's work
    is linear in the frames but the time attention's, which is quadratic:
    the count at three frame numbers fixes the polynomial exactly, and a
    fourth is checked against it."""
    points = (101, 201, 401)
    f = [generator_forward_flops(num_channel, num_features, t) for t in points]
    # exact quadratic through the three points (integer arithmetic)
    (t0, t1, t2), (f0, f1, f2) = points, f
    d01, d12 = (f1 - f0) / (t1 - t0), (f2 - f1) / (t2 - t1)
    a = (d12 - d01) / (t2 - t0)
    b = d01 - a * (t0 + t1)
    c = f0 - a * t0 * t0 - b * t0

    def flops(frames: int) -> float:
        return a * frames * frames + b * frames + c

    probe = 161
    counted = generator_forward_flops(num_channel, num_features, probe)
    if abs(flops(probe) - counted) > 1e-9 * counted:
        raise AssertionError(f"FLOPs not quadratic in frames: {flops(probe)} vs {counted}")
    return flops


def training_step_flops(num_channel: int, num_features: int, ndf: int, rows: int,
                        samples: int, n_fft: int, hop: int, power: float,
                        gan_active: bool) -> int:
    """One SCP-GAN step of the reference on ``rows`` crops of ``samples``:
    the generator's losses forward and backward (the featurization's DFT
    matmuls with them), the GAN term through the discriminator where
    active, and the discriminator's three-pass step where active."""
    with torch.device("meta"):
        gen, disc = TSCNet(num_channel, num_features), Discriminator(ndf)
    gen.train()
    disc.train()
    audio = torch.empty(rows, samples, device="meta")

    def gen_step():
        re, im = dsp.compressed_stft(audio, n_fft, hop, power)
        est_re, est_im = gen(re, im)
        est = dsp.uncompressed_istft(est_re, est_im, n_fft, hop, power, samples)
        e_re, e_im = dsp.compressed_stft(est, n_fft, hop, power)
        loss = (e_re.abs().mean() + e_im.abs().mean() + est.abs().mean())
        if gan_active:
            loss = loss + disc(re.abs(), torch.sqrt(e_re ** 2 + e_im ** 2)).mean()
        loss.backward()

    def disc_step():
        mag = torch.empty(rows, samples // hop + 1, num_features, device="meta")
        for _ in range(3):
            disc(mag, mag).mean().backward()

    return _count(gen_step) + (_count(disc_step) if gan_active else 0)
