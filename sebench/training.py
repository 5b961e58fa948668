"""The training driver's pieces: the corpus, the program as
``cli.main_gan.train`` builds it, and the comparison of its first steps
with the plain reference's."""

from __future__ import annotations

import os
import statistics

import numpy as np
import torch
from scipy.io import wavfile

from sebench import synth


def write_corpus(bench, root: str) -> tuple[str, str, list[tuple[str, str]]]:
    """``root/{clean,noisy}/uNNNN.wav`` (16-bit PCM): speech of lengths
    spread evenly over the cell's range, in an order drawn from the seed,
    with pink noise at the cell's SNRs in turn.  Returns the two
    directories and the (clean, noisy) pairs in file-name order."""
    p, sr = bench.params, bench.config["sample_rate"]
    rng = bench.rng("corpus")
    lengths = synth.uniform_lengths(p["corpus_pairs"], p["min_s"], p["max_s"], sr)
    lengths = [lengths[i] for i in rng.permutation(len(lengths))]
    clean = synth.speech(rng, lengths, bench.device)
    noisy = synth.noisy(rng, clean, p["snr_db"])
    dirs = [os.path.join(root, "clean"), os.path.join(root, "noisy")]
    pairs = []
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i, (c, n) in enumerate(zip(clean, noisy)):
        names = [os.path.join(d, f"u{i:04d}.wav") for d in dirs]
        for name, x in zip(names, (c, n)):
            wavfile.write(name, sr, np.clip(x * 32768.0, -32768, 32767).astype(np.int16))
        pairs.append(tuple(names))
    return dirs[0], dirs[1], pairs


def first_gradients(opt, module, initial: dict) -> dict:
    """``{name: gradient}`` of the optimizer's first update, worked out from
    its momentum buffers after that update (buffer = gradient + weight
    decay x parameter before it); zeros for a parameter with no buffer."""
    decay = {id(p): g["weight_decay"] for g in opt.rule.param_groups for p in g["params"]}
    out = {}
    for name, p in module.named_parameters():
        buf = opt.rule.state.get(p, {}).get("momentum_buffer")
        out[name] = (torch.zeros_like(p) if buf is None
                     else buf - decay[id(p)] * initial[name]).detach().clone()
    return out


def norms(tensors) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(t.double())) for t in tensors])


def leaf_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The gap between two per-leaf norms, each against the larger of the
    reference leaf's norm and the median leaf's."""
    return np.abs(got - want) / np.maximum(want, statistics.median(want.tolist()))


def compare(bench, program: dict, ref: dict, init: dict, gan_active: bool) -> None:
    """Adds the three numbers compared:

    * ``train_loss_gap``: the largest relative gap of the generator's loss
      over the steps followed;
    * ``train_grad_gap``: the first gradient of each model as its
      optimizer got it, by the median leaf (the gap of each leaf's norm
      against the larger of the reference leaf's norm and the median
      leaf's; the larger of the models' medians);
    * ``train_change_gap``: the same of the parameters' change over the
      steps; leaves whose reference gradient is under a thousandth of the
      median leaf's are left out, as rounding alone moves them.

    Every reading the limits were chosen from (each step's loss gap, the
    discriminator's loss gap, the worst leaves) goes to
    ``bench.counters['readings']``."""
    limits = bench.workload["limits"]
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(program["gen_losses"], ref["gen_losses"])]
    if len(program["gen_losses"]) != len(ref["gen_losses"]):
        rel = [float("inf")]
    readings: dict = {"gen_loss_gaps": rel}
    if gan_active:
        got, want = program["disc_losses"][:1], ref["disc_losses"][:1]
        readings["disc_loss_gap"] = (abs(got[0] - want[0]) / max(abs(want[0]), 1e-12)
                                     if got and want else float("inf"))
    grad_median = change_median = 0.0
    for m in ["gen"] + (["disc"] if gan_active else []):
        names = list(ref[f"{m}_grads"])
        if sorted(names) != sorted(program[f"{m}_grads"]):
            raise ValueError(f"the program's {m} parameters are not the reference's")
        g_ref = norms(ref[f"{m}_grads"][n] for n in names)
        g_prog = norms(program[f"{m}_grads"][n] for n in names)
        gaps = leaf_gaps(g_prog, g_ref)
        keep = g_ref >= 1e-3 * statistics.median(g_ref.tolist())
        kept = [n for n, k in zip(names, keep) if k]
        d_ref = norms(ref[f"{m}_params"][n] - init[m][n] for n in kept)
        d_prog = norms(program[f"{m}_params"][n] - init[m][n] for n in kept)
        changes = leaf_gaps(d_prog, d_ref)
        grad_median = max(grad_median, float(np.median(gaps)))
        change_median = max(change_median, float(np.median(changes)))
        i, j = int(gaps.argmax()), int(changes.argmax())
        readings[m] = {
            "grad_median": float(np.median(gaps)), "change_median": float(np.median(changes)),
            "grad_worst": [names[i], float(gaps[i]), float(g_prog[i]), float(g_ref[i])],
            "change_worst": [kept[j], float(changes[j]), float(d_prog[j]), float(d_ref[j])],
            "left_out": [n for n, k in zip(names, keep) if not k]}
    bench.counters["readings"] = readings
    bench.check("train_loss_gap", max(rel), limits["train_loss_gap"])
    bench.check("train_grad_gap", grad_median, limits["train_grad_gap"])
    bench.check("train_change_gap", change_median, limits["train_change_gap"])
