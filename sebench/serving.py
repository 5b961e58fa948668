"""What the serving drivers share: the program as ``cli.inference_gan``
builds it (``TSCNet`` with the fused route on a card, weights from the
seed, ``Enhancer`` at the CLI's precision), the utterance pool, the
observation of K1's launch shapes, and the correctness check.

The pool is one set of noisy utterances whose lengths are the same for
every seed (``synth.lognormal_lengths``); each job or round sends all of
them in an order drawn from the seed.  The check runs the plain reference
(``reference/enhance.py``) on every (utterance, bucket) pair that the
window's outputs came from, and compares every output of the window.
"""

from __future__ import annotations

import numpy as np
import torch

from sebench import synth, weights
from sebench.reference import enhance as ref_enhance
from sebench.reference.models import TSCNet as RefTSCNet
from sebench.reference.precision import ieee_fp32


def build(bench, precision: str | None = None):
    """(enhancer, initial generator state dict) for the configuration;
    ``precision`` overrides the configuration's serving precision (the
    control runs the program's bf16 path)."""
    from speech_enhancement_tpu_torch.enhance import Enhancer
    from speech_enhancement_tpu_torch.models import TSCNet

    cfg, serving = bench.config, bench.config["serving"]
    precision = precision or bench.params.get("precision") or serving["precision"]
    fused = serving["fused_attention"] == "on" or (
        serving["fused_attention"] == "auto" and bench.device.type == "cuda")
    state = weights.seeded_state(RefTSCNet(cfg["num_channel"], cfg["num_features"]),
                                 bench.seed_of("generator"), bench.device)
    gen = TSCNet(cfg["num_channel"], cfg["num_features"], fused_attention=fused,
                 device=bench.device)
    gen.load_state_dict(state)
    enhancer = Enhancer(gen, cfg["n_fft"], cfg["hop"], quantum=serving["bucket_samples"],
                        compute_dtype=torch.bfloat16 if precision == "bf16" else None,
                        fused_stft=fused, device=bench.device)
    return enhancer, state


def pool(bench) -> tuple[list[int], list[np.ndarray]]:
    p = bench.params
    lengths = synth.lognormal_lengths(p["utterances"], p["median_s"], p["sigma"], p["min_s"],
                                      p["max_s"])
    rng = bench.rng("audio")
    clean = synth.speech(rng, lengths, bench.device)
    return lengths, synth.noisy(rng, clean, p["snr_db"])


def order(bench, round_index: int, count: int) -> list[int]:
    return [int(i) for i in bench.rng("order", round_index).permutation(count)]


def watch_k1(enhancer, sink: list) -> list:
    """Forward hooks that append ``(sequences, frames)`` of each call of an
    attention module on the fused route (K1) to ``sink``; returns the
    handles."""
    handles = []
    for module in enhancer.model.modules():
        if getattr(module, "fused", False) and hasattr(module, "rel_pos_emb"):
            handles.append(module.register_forward_pre_hook(
                lambda mod, args: sink.append(tuple(args[0].shape[:2]))))
    return handles


def served_frames(lengths: list[int], hop: int) -> list[int]:
    """Frames of each utterance's own length rounded up to a hop."""
    return [-(-n // hop) + 1 for n in lengths]


def check(bench, init_state: dict, utterances: list[np.ndarray], served: list, batch_size: int
          ) -> None:
    """``served`` is ``[(job order, outputs)]``: every output compared with
    the reference's enhancement of its utterance at the bucket the served
    semantics give it.  Adds ``serve_rel_err``, the largest relative RMS
    distance of an output from the reference, and counts as failed every
    output missing, of the wrong length or not finite."""
    cfg = bench.config
    quantum = cfg["serving"]["bucket_samples"]
    lengths = [len(u) for u in utterances]
    pairs, jobs = set(), []
    for job_order, outputs in served:
        bucket = ref_enhance.buckets([lengths[i] for i in job_order], batch_size, quantum)
        jobs.append([(i, b, out) for i, b, out in zip(job_order, bucket, outputs)])
        pairs |= {(i, b) for i, b in zip(job_order, bucket)}
    model = RefTSCNet(cfg["num_channel"], cfg["num_features"]).to(bench.device)
    model.load_state_dict(init_state)
    model.eval()
    with ieee_fp32():
        ref = ref_enhance.enhance_pairs(model, utterances, pairs, n_fft=cfg["n_fft"],
                                        hop=cfg["hop"], power=cfg["compress_power"],
                                        device=bench.device)
    worst, failed = 0.0, 0
    for job in jobs:
        for i, b, out in job:
            want = ref[(i, b)]
            if out is None or len(out) != len(want) or not np.all(np.isfinite(out)):
                failed += 1
                continue
            err = np.linalg.norm(out.astype(np.float64) - want) / np.linalg.norm(want)
            worst = max(worst, float(err))
    bench.failed += failed
    bench.check("serve_rel_err", worst, bench.workload["limits"]["serve_rel_err"])
