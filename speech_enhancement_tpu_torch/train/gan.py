"""SCP-GAN / CMGAN train and eval steps (port of
speech_enhancement_tpu/train/gan.py).

* :func:`gan_generator_step`: featurize -> generate -> iSTFT -> the
  consistency (scp/cp) or plain (sc/cmgan) losses, plus the GAN term
  through the discriminator (no gradient into its parameters, no
  spectral refresh), one optimizer update.  ``compute_dtype=bfloat16``
  runs the generator on a bf16 copy of the fp32 master parameters
  (``torch.func.functional_call``), with gradients flowing back through
  the cast; BatchNorm statistics, the DSP and every loss stay fp32.
* :func:`gan_discriminator_step`: the self-correcting three-term step for
  scp/sc (three serial gradient passes whose 3x3 Gram matrix gives the
  combination weights, :func:`_sc_weights_from_gram`) or the two-term
  step for cp/cmgan, one update, then one spectral-norm refresh.
* :func:`make_fused_gan_train_step`: generator step -> host PESQ labels
  (the native C++ engine, ``metrics/pesq.py``) -> discriminator step; the
  loop body of the two-phase ``cli/main_gan.py``.
* :func:`gan_eval_step`: the validation losses, optionally per example.

Randomness is explicit: each step takes an integer seed and runs under
``torch.random.fork_rng`` seeded from it (dropout masks), so the same call
on the same state gives the same result and leaves the global RNG as it
was.  The steps update the modules and optimizers of the state in place.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch

from speech_enhancement_tpu_torch.metrics.pesq import batch_pesq_raw
from speech_enhancement_tpu_torch.ops.stft import (
    batch_stft,
    compressed_stft,
    uncompressed_istft,
)
from speech_enhancement_tpu_torch.train.state import GanTrainState

LOSS_WEIGHTS = (0.1, 0.9, 0.2, 0.05)  # ri, mag, time, gan


class GenAux(NamedTuple):
    """Outputs of the generator phase that the host (PESQ labels) and the
    discriminator phase need."""

    est_audio: torch.Tensor
    clean_audio: torch.Tensor
    noisy_audio: torch.Tensor
    est_mag: torch.Tensor
    clean_mag: torch.Tensor
    noisy_mag: torch.Tensor
    metrics: dict


@contextlib.contextmanager
def _seeded(seed: int, device: torch.device):
    """The global RNGs (CPU and ``device``) seeded from ``seed`` inside,
    restored on exit."""
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield


def _per_row(criterion: Callable) -> Callable:
    return lambda pred, target: torch.stack(
        [criterion(p, t) for p, t in zip(pred, target)])


def _generator_losses(gen_fn: Callable, clean: torch.Tensor, noisy: torch.Tensor, *,
                      arch: str, criterion: Callable, comp_type: str, n_fft: int,
                      hop: int, compute_dtype: torch.dtype | None = None,
                      per_example: bool = False):
    """The generator losses (``gan.py:92-203``).  ``gen_fn`` maps the
    noisy spectrogram (complex, or an (re, im) pair in ``compute_dtype``)
    to ``(re, im)``.  Returns (losses dict, aux dict).  ``per_example``
    gives each loss as a ``[B]`` vector."""
    if per_example:
        criterion = _per_row(criterion)
        mean = lambda x: x.reshape(x.shape[0], -1).mean(dim=1)  # noqa: E731
    else:
        mean = torch.mean
    clean, noisy, clean_spec, noisy_spec, _ = batch_stft(clean, noisy, n_fft, hop)
    if compute_dtype is not None:
        spec_in = (noisy_spec.real.to(compute_dtype), noisy_spec.imag.to(compute_dtype))
    else:
        spec_in = noisy_spec
    est_real, est_imag = gen_fn(spec_in)
    est_real, est_imag = est_real.float(), est_imag.float()
    est_spec = torch.complex(est_real, est_imag)
    est_mag = est_spec.abs()
    clean_mag = clean_spec.abs()
    length = clean.shape[-1]
    est_audio = uncompressed_istft(est_spec, n_fft, hop, comp_type="pow", length=length)

    if arch in ("scp", "cp"):
        # consistency-preserving: the re-featurized estimate against the
        # iSTFT -> STFT round trip of the clean spectrogram
        est_prime = compressed_stft(est_audio, n_fft, hop, comp_type=comp_type)
        clean_prime_audio = uncompressed_istft(clean_spec, n_fft, hop, comp_type="pow",
                                               length=length)
        clean_prime = compressed_stft(clean_prime_audio, n_fft, hop, comp_type=comp_type)
        loss_mag = criterion(est_prime.abs(), clean_prime.abs())
        time_loss = mean(torch.abs(est_audio - clean_prime_audio))
        loss_ri = (criterion(est_prime.real, clean_prime.real)
                   + criterion(est_prime.imag, clean_prime.imag))
    else:
        loss_mag = criterion(est_mag, clean_mag)
        time_loss = mean(torch.abs(est_audio - clean))
        loss_ri = (criterion(est_real, clean_spec.real)
                   + criterion(est_imag, clean_spec.imag))

    losses = {"loss_ri": loss_ri, "loss_mag": loss_mag, "time_loss": time_loss}
    aux = {"est_audio": est_audio, "clean_audio": clean, "noisy_audio": noisy,
           "est_mag": est_mag, "clean_mag": clean_mag, "noisy_mag": noisy_spec.abs()}
    return losses, aux


def _total(losses: dict, gan_loss: torch.Tensor, gan_active: bool,
           loss_weights: tuple) -> torch.Tensor:
    w = loss_weights
    total = (w[0] * losses["loss_ri"] + w[1] * losses["loss_mag"]
             + w[2] * losses["time_loss"])
    return total + w[3] * gan_loss if gan_active else total


def gan_generator_step(state: GanTrainState, clean: torch.Tensor, noisy: torch.Tensor,
                       seed: int, *, criterion: Callable, arch: str = "scp",
                       comp_type: str = "pow", n_fft: int = 400, hop: int = 100,
                       gan_active: bool = True, loss_weights: tuple = LOSS_WEIGHTS,
                       compute_dtype: torch.dtype | None = None) -> GenAux:
    """One generator update (``gan.py:206-301``) on ``[B, L]`` audio.
    Returns the :class:`GenAux` of the step, with its losses under
    ``metrics`` (detached)."""
    gen, disc = state.gen, state.disc
    gen.train()
    disc.train()  # the GAN term runs the discriminator with dropout
    names, params = zip(*gen.named_parameters())
    if compute_dtype is not None:
        cast = {n: p.to(compute_dtype) for n, p in zip(names, params)}
        gen_fn = lambda spec: torch.func.functional_call(gen, cast, (spec,))  # noqa: E731
    else:
        gen_fn = gen
    with _seeded(seed, clean.device):
        losses, aux = _generator_losses(gen_fn, clean, noisy, arch=arch,
                                        criterion=criterion, comp_type=comp_type,
                                        n_fft=n_fft, hop=hop, compute_dtype=compute_dtype)
        if gan_active:
            d_fake = disc(aux["clean_mag"], aux["est_mag"]).reshape(-1)
            gan_loss = criterion(d_fake, torch.ones_like(d_fake))
        else:
            gan_loss = torch.zeros((), dtype=clean.dtype, device=clean.device)
        total = _total(losses, gan_loss, gan_active, loss_weights)
        # grads of the generator's parameters only: none reach the
        # discriminator, whose .grad stays untouched
        grads = torch.autograd.grad(total, params)
    for p, g in zip(params, grads):
        p.grad = g
    state.gen_opt.step()
    state.gen_opt.zero_grad()
    state.gen_step += 1
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics.update(gan_loss=gan_loss.detach(), loss=total.detach())
    return GenAux(est_audio=aux["est_audio"].detach(), clean_audio=aux["clean_audio"],
                  noisy_audio=aux["noisy_audio"], est_mag=aux["est_mag"].detach(),
                  clean_mag=aux["clean_mag"], noisy_mag=aux["noisy_mag"],
                  metrics=metrics)


def _sc_weights_from_gram(gram: torch.Tensor) -> torch.Tensor:
    """SCP-GAN's weights ``[w_c, w_e, w_n]`` from the 3x3 Gram matrix of the
    flattened (grad_c, grad_e, grad_n) rows (``gan.py:308-326``), branch for
    branch."""
    c_dot_e, c_dot_n, e_dot_n = gram[0, 1], gram[0, 2], gram[1, 2]
    e_dot_e = gram[1, 1] + 1e-14
    n_dot_n = gram[2, 2] + 1e-14
    one = torch.ones((), dtype=gram.dtype, device=gram.device)
    w_e = torch.where(c_dot_e > 0, one, -c_dot_e / e_dot_e)
    s = c_dot_n + w_e * e_dot_n  # dot(w_c gC + w_e gE, gN)
    w_n_pos = -(c_dot_n + e_dot_n) / n_dot_n
    w_n_neg = -c_dot_n / n_dot_n + c_dot_e * e_dot_n / (e_dot_e * n_dot_n)
    w_n = torch.where(s > 0, one, torch.where(c_dot_e > 0, w_n_pos, w_n_neg))
    return torch.stack([one, w_e, w_n])


def _flat(grads) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads])


def self_correcting_weights(grad_c, grad_e, grad_n):
    """The self-correcting combination weights of three gradient lists
    (``gan.py:329-335``)."""
    g = torch.stack([_flat(grad_c), _flat(grad_e), _flat(grad_n)])
    w = _sc_weights_from_gram(g @ g.T)
    return w[0], w[1], w[2]


def gan_discriminator_step(state: GanTrainState, aux: GenAux, pesq_est: torch.Tensor,
                           pesq_clean: torch.Tensor, pesq_noisy: torch.Tensor,
                           seed: int, *, criterion: Callable,
                           arch: str = "scp") -> torch.Tensor:
    """One discriminator update (``gan.py:342-432``).  ``pesq_*`` are the
    normalized PESQ labels ((pesq - 1) / 3.5) of est, clean and noisy
    against clean; cp/cmgan use ``pesq_est`` only.  Returns the
    discriminator loss (detached)."""
    disc = state.disc
    disc.train()
    params = list(disc.parameters())
    clean_mag, est_mag, noisy_mag = aux.clean_mag, aux.est_mag, aux.noisy_mag

    def loss_of(other, label):
        return criterion(disc(clean_mag, other).reshape(-1), label)

    with _seeded(seed, clean_mag.device):
        if arch in ("scp", "sc"):
            losses, grads = [], []
            for other, label in ((clean_mag, pesq_clean), (est_mag, pesq_est),
                                 (noisy_mag, pesq_noisy)):
                loss = loss_of(other, label)
                losses.append(loss.detach())
                grads.append(torch.autograd.grad(loss, params))
            w = torch.stack(self_correcting_weights(*grads))
            combined = [w[0] * a + w[1] * b + w[2] * c for a, b, c in zip(*grads)]
            disc_loss = torch.dot(w, torch.stack(losses))
        else:
            loss = (loss_of(clean_mag, torch.ones_like(pesq_est))
                    + loss_of(est_mag, pesq_est))
            combined = torch.autograd.grad(loss, params)
            disc_loss = loss.detach()
    for p, g in zip(params, combined):
        p.grad = g
    state.disc_opt.step()
    state.disc_opt.zero_grad()
    # one power-iteration step per update, on the new weights
    disc.refresh_()
    state.disc_step += 1
    return disc_loss


def host_pesq_labels(clean: torch.Tensor, other: torch.Tensor,
                     sample_rate: int = 16000) -> torch.Tensor:
    """Normalized PESQ labels ``(pesq(clean, other) - 1) / 3.5`` from the
    port's native batch engine (``metrics/pesq.py``), on the device of
    ``other``."""
    scores = batch_pesq_raw(clean.detach().float().cpu().numpy(),
                            other.detach().float().cpu().numpy(), sample_rate)
    labels = ((scores - 1.0) / 3.5).astype(np.float32)
    return torch.from_numpy(labels).to(other.device)


def make_fused_gan_train_step(*, criterion: Callable, arch: str = "scp",
                              comp_type: str = "pow", n_fft: int = 400, hop: int = 100,
                              gan_active: bool = True,
                              loss_weights: tuple = LOSS_WEIGHTS,
                              sample_rate: int = 16000,
                              compute_dtype: torch.dtype | None = None):
    """The whole GAN step (``gan.py:435-511``): generator update, host PESQ
    labels, discriminator update.

    Returns ``step(state, clean, noisy, seed, q_clean=None, q_noisy=None)
    -> metrics``.  ``q_clean`` / ``q_noisy`` are the normalized labels of
    clean and noisy against clean, which a data collator can precompute;
    when omitted they are computed here.  The generator and discriminator
    phases draw their dropout from two seeds derived from ``seed``."""

    def step(state: GanTrainState, clean: torch.Tensor, noisy: torch.Tensor, seed: int,
             q_clean: torch.Tensor | None = None, q_noisy: torch.Tensor | None = None):
        seed_gen, seed_disc = (int(s) for s in np.random.SeedSequence(seed).generate_state(2))
        aux = gan_generator_step(state, clean, noisy, seed_gen, criterion=criterion,
                                 arch=arch, comp_type=comp_type, n_fft=n_fft, hop=hop,
                                 gan_active=gan_active, loss_weights=loss_weights,
                                 compute_dtype=compute_dtype)
        if not gan_active:
            return {**aux.metrics, "disc_loss": torch.zeros((), device=clean.device)}
        length = aux.est_audio.shape[-1]
        ref = aux.clean_audio[:, :length]
        q_est = host_pesq_labels(ref, aux.est_audio, sample_rate)
        if q_clean is None:
            q_clean = host_pesq_labels(ref, ref, sample_rate)
        if q_noisy is None:
            q_noisy = host_pesq_labels(ref, aux.noisy_audio[:, :length], sample_rate)
        disc_loss = gan_discriminator_step(state, aux, q_est, q_clean, q_noisy, seed_disc,
                                           criterion=criterion, arch=arch)
        return {**aux.metrics, "disc_loss": disc_loss}

    return step


@torch.no_grad()
def gan_eval_step(state: GanTrainState, clean: torch.Tensor, noisy: torch.Tensor, *,
                  criterion: Callable, arch: str = "scp", comp_type: str = "pow",
                  n_fft: int = 400, hop: int = 100, gan_active: bool = True,
                  loss_weights: tuple = LOSS_WEIGHTS, per_example: bool = False):
    """Validation losses (``gan.py:521-580``), both models in eval mode:
    returns (losses dict, :class:`GenAux`) with ``d_fake`` and ``d_real``
    among the aux metrics.  ``per_example=True`` gives every loss as a
    ``[B]`` vector, so that pad rows of a padded tail batch can be masked
    exactly."""
    gen, disc = state.gen, state.disc
    gen.eval()
    disc.eval()
    losses, aux = _generator_losses(gen, clean, noisy, arch=arch, criterion=criterion,
                                    comp_type=comp_type, n_fft=n_fft, hop=hop,
                                    per_example=per_example)
    d_fake = disc(aux["clean_mag"], aux["est_mag"]).reshape(-1)
    crit = _per_row(criterion) if per_example else criterion
    gan_loss = crit(d_fake, torch.ones_like(d_fake))
    losses["gan_loss"] = gan_loss
    losses["loss"] = _total(losses, gan_loss, gan_active, loss_weights)
    d_real = disc(aux["clean_mag"], aux["clean_mag"]).reshape(-1)
    return losses, GenAux(**{k: aux[k] for k in GenAux._fields if k != "metrics"},
                          metrics={**losses, "d_fake": d_fake, "d_real": d_real})
