"""Conditional diffusion: the forward process, the reverse schedule, the
train and eval steps of both families, and the two reverse samplers (port
of speech_enhancement_tpu/train/diffusion.py).

* :func:`add_noise`, :func:`inference_schedule`: the CDiffuSE forward
  process and the host numpy (float64) reverse-process coefficients, with
  the interpolated fast schedule and the ``ValueError`` outside the
  reverse process's domain.
* :func:`diffuse_step` (waveform DiffuSE) and :func:`tsc_diffusion_step`
  (spectrogram diffusion TSCNet): one optimizer update, or the loss alone
  with ``train=False``.  ``compute_dtype=torch.bfloat16`` runs the model
  on a bf16 copy of the fp32 master parameters
  (``torch.func.functional_call``, as ``train/gan.py``), with gradients
  flowing back through the cast; the STFTs, the noising and the loss stay
  fp32, and so do BatchNorm statistics.  The featurization is the plain,
  differentiable ``ops/stft.py``: the loss differentiates through the
  iSTFT, and K5 has no backward.
* :func:`sample_waveform` and :func:`sample_tsc`: the reverse samplers as
  a Python loop over the steps.  Their STFTs and iSTFTs need no gradient
  and go through K4 and K5 (``ops/fused_stft.py``) where the kernels take
  the compression and geometry (``comp_type`` ``'pow'`` or ``'none'``,
  ``fused_stft.supports``); ``'norm'``, ``'log'`` and other geometries go
  through ``ops/stft.py``.  ``plain=True`` takes ``ops/stft.py`` always:
  the route that the tests and ``chip_smoke.py`` hold the kernel route
  against.  A sampler sets its model to eval mode.

Data parallel (a process group of more than one rank, ``parallel/``):
a training step averages its gradients and its loss over the ranks before
the update, and the returned gradient norm is the global gradient's; an
eval step (``train=False``) returns its rank's loss.  Each rank folds its
rank into the step's seeds (``parallel.rank_seed``), so that the ranks
draw their own timesteps, noise and dropout for their rows.

Randomness is explicit.  A step takes an integer seed: the timestep and
noise draws come from a ``torch.Generator`` seeded from it, the TSCNet's
dropout from the global RNG seeded (and restored after) from it, so the
same call on the same state gives the same result.  A sampler takes a
``torch.Generator`` for its per-step Gaussian draws.  JAX's ``split``
streams cannot be matched, so :func:`add_noise`, the steps and the
samplers also take their draws as tensors (``t``, ``noise``, ``noises``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from speech_enhancement_tpu_torch.ops import fused_stft as fs
from speech_enhancement_tpu_torch.ops.stft import (
    compressed_stft,
    normalize_batch,
    stft,
    uncompressed_istft,
)
from speech_enhancement_tpu_torch.parallel.mesh import all_reduce_mean_, rank_seed
from speech_enhancement_tpu_torch.train.gan import _seeded, phase_seeds
from speech_enhancement_tpu_torch.train.state import ModuleState


def linear_noise_schedule(num_steps: int = 50) -> np.ndarray:
    """beta = linspace(1e-4, 0.035, N) (``diffusion.py:31-33``)."""
    return np.linspace(1e-4, 0.035, num_steps)


def add_noise(audio: torch.Tensor, noisy: torch.Tensor, noise_schedule,
              generator: torch.Generator | None = None, *, t: torch.Tensor | None = None,
              noise: torch.Tensor | None = None):
    """The CDiffuSE conditional forward process (``diffusion.py:36-60``):
    clean moves towards noisy by the mass m(t), plus Gaussian noise.
    Returns ``(noisy_audio, combine_noise, t)``, one timestep per row.  The
    timesteps (uniform in ``[0, N)``) and the noise are drawn from
    ``generator`` unless given."""
    n = audio.shape[0]
    beta = torch.as_tensor(np.asarray(noise_schedule), dtype=audio.dtype, device=audio.device)
    noise_level = torch.cumprod(1.0 - beta, 0)
    if t is None:
        t = torch.randint(0, beta.shape[0], (n,), generator=generator, device=audio.device)
    if noise is None:
        noise = torch.randn(audio.shape, generator=generator, dtype=audio.dtype,
                            device=audio.device)
    level = noise_level[t]
    noise_scale = level[:, None]
    noise_scale_sqrt = noise_scale ** 0.5
    m = (((1.0 - level) / level ** 0.5) ** 0.5)[:, None]
    spread = (1.0 - (1.0 + m ** 2) * noise_scale) ** 0.5 * noise
    noisy_audio = ((1.0 - m) * noise_scale_sqrt * audio + m * noise_scale_sqrt * noisy
                   + spread)
    combine_noise = (m * noise_scale_sqrt * (noisy - audio) + spread) / (1.0 - noise_scale) ** 0.5
    return noisy_audio, combine_noise, t


class ReverseSchedule(NamedTuple):
    """Per-step reverse-process coefficients, indexed by n in [0, N); the
    sampler runs n = N - 1 down to 0."""

    alpha: np.ndarray
    beta: np.ndarray
    alpha_cum: np.ndarray
    sigmas: np.ndarray
    T: np.ndarray  # (possibly fractional) training-timestep map
    c1: np.ndarray
    c2: np.ndarray
    c3: np.ndarray
    delta: np.ndarray
    delta_bar: np.ndarray


def inference_schedule(noise_schedule, inference_noise_schedule=None,
                       fast: bool = False) -> ReverseSchedule:
    """Host-side reverse-process coefficients (``diffusion.py:79-167``), in
    float64; ``fast`` maps the inference steps (e.g. the 6-step schedule)
    onto fractional training timesteps.  Raises ``ValueError`` for a
    schedule outside the reverse process's domain."""
    training = np.asarray(noise_schedule, np.float64)
    if fast:
        if inference_noise_schedule is None:
            raise ValueError("fast sampling needs an inference noise schedule")
        beta = np.asarray(inference_noise_schedule, np.float64)
    else:
        beta = training

    talpha = 1.0 - training
    talpha_cum = np.cumprod(talpha)
    alpha = 1.0 - beta
    alpha_cum = np.cumprod(alpha)
    n_steps = len(alpha)

    sigmas = np.zeros(n_steps)
    for n in range(n_steps - 1, -1, -1):
        sigmas[n] = (1.0 - alpha_cum[n - 1]) / (1.0 - alpha_cum[n]) * beta[n]

    T = []
    for s in range(n_steps):
        for t in range(len(training) - 1):
            if talpha_cum[t + 1] <= alpha_cum[s] <= talpha_cum[t]:
                twiddle = (talpha_cum[t] ** 0.5 - alpha_cum[s] ** 0.5) / (
                    talpha_cum[t] ** 0.5 - talpha_cum[t + 1] ** 0.5)
                T.append(t + twiddle)
                break
    T = np.array(T, np.float32)

    m = np.array([min((1.0 - ac) / ac ** 0.5, 1.0) ** 0.5 for ac in alpha_cum])
    if np.any(m[:-1] >= 1.0) or alpha_cum[-1] >= 0.5:
        # the coefficients divide by (1 - m[n-1]) and by delta[n]: every
        # intermediate m must stay below the clamp (alpha_cum > 0.382
        # before the last step) and delta[-1] = 1 - 2 alpha_cum[-1] > 0
        imin = float(alpha_cum[:-1].min()) if n_steps > 1 else float("nan")
        raise ValueError(
            "noise schedule is outside the CDiffuSE reverse-process "
            f"domain (alpha_cum must stay > 0.382 before the final step "
            f"and end below 0.5; got intermediate min {imin:.4f}, final "
            f"{alpha_cum[-1]:.4f}) — adjust the step count or betas")
    m[-1] = 1.0
    delta = np.maximum(1.0 - (1.0 + m ** 2) * alpha_cum, 0.0)

    delta_cond = np.zeros(n_steps)
    delta_bar = np.zeros(n_steps)
    c1 = np.zeros(n_steps)
    c2 = np.zeros(n_steps)
    c3 = np.zeros(n_steps)
    for n in range(n_steps):
        if n > 0:
            delta_cond[n] = (delta[n] - ((1.0 - m[n]) / (1.0 - m[n - 1])) ** 2 * alpha[n]
                             * delta[n - 1])
            delta_bar[n] = delta_cond[n] * delta[n - 1] / delta[n]
            c1[n] = ((1.0 - m[n]) / (1.0 - m[n - 1]) * (delta[n - 1] / delta[n])
                     * alpha[n] ** 0.5
                     + (1.0 - m[n - 1]) * (delta_cond[n] / delta[n]) / alpha[n] ** 0.5)
            c2[n] = (m[n - 1] * delta[n]
                     - (m[n] * (1.0 - m[n])) / (1.0 - m[n - 1]) * alpha[n] * delta[n - 1]
                     ) * (alpha_cum[n - 1] ** 0.5 / delta[n])
            c3[n] = ((1.0 - m[n - 1]) * (delta_cond[n] / delta[n])
                     * (1.0 - alpha_cum[n]) ** 0.5 / alpha[n] ** 0.5)
        else:
            c1[n] = 1.0 / alpha[n] ** 0.5
            c3[n] = c1[n] * beta[n] / (1.0 - alpha_cum[n]) ** 0.5
    return ReverseSchedule(
        alpha, beta, alpha_cum, sigmas, T,
        c1.astype(np.float32), c2.astype(np.float32), c3.astype(np.float32),
        delta.astype(np.float32), delta_bar.astype(np.float32))


def _forward(model: torch.nn.Module, compute_dtype: torch.dtype | None) -> Callable:
    """``model``, or with ``compute_dtype`` the model on a copy of its
    parameters in that dtype (the cast stays in the autograd graph)."""
    if compute_dtype is None:
        return model
    cast = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    return lambda *args: torch.func.functional_call(model, cast, args)


def _update(state: ModuleState, loss: torch.Tensor,
            grad_norm: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One optimizer update from ``loss``; a parameter that ``loss`` does
    not reach (DiffuSE's last residual conv) gets a zero gradient, as in
    JAX, so that weight decay still applies to it.  With more than one
    rank the gradients and the loss are averaged over the ranks first
    (``parallel.all_reduce_mean_``): the global batch's.  Returns the
    (global) loss, detached, and with ``grad_norm`` the global L2 norm of
    the gradients before the update (``optax.global_norm``), else None."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    loss = loss.detach().clone()
    all_reduce_mean_([*grads, loss])
    norm = torch.nn.utils.get_total_norm(grads) if grad_norm else None
    for p, g in zip(params, grads):
        p.grad = g
    state.opt.step()
    state.opt.zero_grad()
    state.step += 1
    return loss, norm


def diffuse_train_loss(model: torch.nn.Module, clean: torch.Tensor, noisy: torch.Tensor,
                       noise_schedule, generator: torch.Generator | None = None, *,
                       n_fft: int = 400, hop: int = 100,
                       compute_dtype: torch.dtype | None = None,
                       t: torch.Tensor | None = None, noise: torch.Tensor | None = None):
    """The waveform DiffuSE's prediction and target (``diffusion.py:170-
    207``): the conditioner is the noisy signal's ``|STFT|`` without its
    last frame (so that ``hop * frames`` spans the crop), the model
    predicts the combined noise.  Returns ``(predicted, combine_noise)``."""
    spectrogram = stft(noisy, n_fft, hop).abs()[:, :-1, :]
    noisy_audio, combine_noise, t = add_noise(clean, noisy, noise_schedule, generator,
                                              t=t, noise=noise)
    if compute_dtype is not None:
        spectrogram, noisy_audio = spectrogram.to(compute_dtype), noisy_audio.to(compute_dtype)
    return _forward(model, compute_dtype)(noisy_audio, spectrogram, t), combine_noise


def diffuse_step(state: ModuleState, clean: torch.Tensor, noisy: torch.Tensor, noise_schedule,
                 seed: int, *, criterion: Callable, n_fft: int = 400, hop: int = 100,
                 train: bool = True, compute_dtype: torch.dtype | None = None,
                 t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                 return_grad_norm: bool = False):
    """Waveform DiffuSE train / eval step (``diffusion.py:220-265``) on
    ``[B, L]`` audio: ``criterion(predicted, combine_noise)`` in fp32, then
    one update unless ``train=False`` or the state has no optimizer.
    Returns the loss (detached), or with ``return_grad_norm`` ``(loss,
    grad_norm)``: the global L2 norm of every gradient before the update
    (zero without an update), as the standalone learner logs it."""
    update = train and state.opt is not None
    state.model.train(update)
    generator = torch.Generator(device=clean.device).manual_seed(rank_seed(seed))
    with torch.set_grad_enabled(update):
        pred, target = diffuse_train_loss(state.model, clean, noisy, noise_schedule, generator,
                                          n_fft=n_fft, hop=hop, compute_dtype=compute_dtype,
                                          t=t, noise=noise)
        loss = criterion(pred.float(), target.float())
    loss, grad_norm = (_update(state, loss, return_grad_norm) if update
                       else (loss.detach(), loss.new_zeros(())))
    if return_grad_norm:
        return loss, grad_norm
    return loss


def tsc_diffusion_step(state: ModuleState, clean: torch.Tensor, noisy: torch.Tensor,
                       noise_schedule, seed: int, *, comp_type: str = "pow", n_fft: int = 400,
                       hop: int = 100, train: bool = True,
                       compute_dtype: torch.dtype | None = None,
                       t: torch.Tensor | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """Spectrogram diffusion train / eval step (``diffusion.py:268-343``):
    RMS-normalize, compressed STFTs of the diffused audio and of the noisy
    conditioner, the TSCNet's spectrogram back through the iSTFT, and the
    L1 loss against the combined noise, all in fp32.  In training the model
    runs in train mode (dropout, BatchNorm statistics updated), then one
    update.  Returns the loss (detached)."""
    seed_noise, seed_drop = phase_seeds(seed)
    update = train and state.opt is not None
    state.model.train(train)
    generator = torch.Generator(device=clean.device).manual_seed(rank_seed(seed_noise))
    with torch.set_grad_enabled(update), _seeded(seed_drop, clean.device):
        c, n, _ = normalize_batch(clean, noisy)
        orig_spec = compressed_stft(n, n_fft, hop, comp_type=comp_type)
        noisy_audio, combine_noise, t = add_noise(c, n, noise_schedule, generator,
                                                  t=t, noise=noise)
        noisy_spec = compressed_stft(noisy_audio, n_fft, hop, comp_type=comp_type)
        if compute_dtype is not None:
            noisy_spec = (noisy_spec.real.to(compute_dtype), noisy_spec.imag.to(compute_dtype))
            orig_spec = (orig_spec.real.to(compute_dtype), orig_spec.imag.to(compute_dtype))
        est_re, est_im = _forward(state.model, compute_dtype)(noisy_spec, orig_spec, t)
        predicted = uncompressed_istft(torch.complex(est_re.float(), est_im.float()), n_fft,
                                       hop, comp_type=comp_type, length=clean.shape[-1])
        loss = torch.mean(torch.abs(predicted - combine_noise))
    if update:
        loss, _ = _update(state, loss)
    return loss.detach()


def _reverse_steps(schedule: ReverseSchedule):
    """``(k, n, c1, c2, c3, sqrt(delta_bar), T)`` of each reverse step, in
    the order run (n = N - 1 down to 0), as float32 values."""
    n_steps = len(schedule.alpha)
    for k, n in enumerate(range(n_steps - 1, -1, -1)):
        yield (k, n, *(float(np.float32(c[n])) for c in (schedule.c1, schedule.c2, schedule.c3)),
               float(np.sqrt(np.float32(schedule.delta_bar[n]))), float(schedule.T[n]))


def _featurizers(n_fft: int, hop: int, comp_type: str, plain: bool):
    """(STFT, iSTFT) of a sampler: K4 and K5 where they take the
    compression and geometry, else ``ops/stft.py``."""
    if not plain and fs.supports(n_fft, hop, comp_type):
        return fs.fused_stft, fs.fused_istft
    return compressed_stft, uncompressed_istft


def _gaussian(noises, k: int, like: torch.Tensor, generator):
    if noises is not None:
        return torch.as_tensor(noises[k], dtype=like.dtype, device=like.device)
    return torch.randn(like.shape, generator=generator, dtype=like.dtype, device=like.device)


@torch.no_grad()
def sample_waveform(model: torch.nn.Module, noisy_signal: torch.Tensor,
                    schedule: ReverseSchedule, generator: torch.Generator | None = None, *,
                    hop: int = 100, n_fft: int = 400, gamma: float = 0.2,
                    clamp_every_step: bool = False, conditioner=None, noises=None,
                    plain: bool = False) -> torch.Tensor:
    """The DiffuSE reverse sampler (``diffusion.py:346-404``) on ``[B, L]``.

    The conditioner is the noisy signal's ``|STFT|`` without its last frame
    (K4 with ``comp_type='none'``), or ``conditioner`` ``[B, frames,
    bins]`` when given; the audio buffer is the noisy signal cut or
    zero-filled to ``hop * frames``.  Each step ``x <- c1 x + c2 y - c3
    eps + sqrt(delta_bar) z`` (clamped to [-1, 1] with
    ``clamp_every_step``); the last drops the y and z terms, blends in
    ``gamma`` of the noisy audio and clamps.  ``noises`` (N entries, in
    the order run; the last step's is not used) replaces the draws from
    ``generator``."""
    model.eval()
    noisy_signal = noisy_signal.float().contiguous()
    if conditioner is not None:
        spec = torch.as_tensor(conditioner, dtype=torch.float32, device=noisy_signal.device)
    else:
        stft_fn, _ = _featurizers(n_fft, hop, "none", plain)
        spec = stft_fn(noisy_signal, n_fft, hop, comp_type="none").abs()[:, :-1, :]
    b = noisy_signal.shape[0]
    length = hop * spec.shape[1]
    take = min(noisy_signal.shape[-1], length)
    noisy_audio = noisy_signal.new_zeros((b, length))
    noisy_audio[:, :take] = noisy_signal[:, :take]
    audio = noisy_audio
    for k, n, c1, c2, c3, dbar_sqrt, t_frac in _reverse_steps(schedule):
        eps = model(audio, spec, audio.new_full((b,), t_frac))
        if n > 0:
            z = _gaussian(noises, k, audio, generator)
            audio = c1 * audio + c2 * noisy_audio - c3 * eps + dbar_sqrt * z
            if clamp_every_step:
                audio = audio.clamp(-1.0, 1.0)
        else:
            audio = ((1.0 - gamma) * (c1 * audio - c3 * eps) + gamma * noisy_audio).clamp(-1.0,
                                                                                          1.0)
    return audio


@torch.no_grad()
def sample_tsc(model: torch.nn.Module, noisy_signal: torch.Tensor, schedule: ReverseSchedule,
               generator: torch.Generator | None = None, *, n_fft: int = 400, hop: int = 100,
               comp_type: str = "pow", gamma: float = 0.2, noises=None,
               plain: bool = False) -> torch.Tensor:
    """The diffusion TSCNet's reverse sampler (``diffusion.py:407-446``) on
    ``[B, L]``, ``L`` a multiple of ``hop``: every step featurizes the
    current audio (K4), runs the model against the noisy signal's
    spectrogram (K4, once), takes its estimate back to audio (K5) and
    updates as :func:`sample_waveform` does, without clamping.  The caller
    RMS-normalizes and pads (``cli/inference_diffuse.py``)."""
    model.eval()
    stft_fn, istft_fn = _featurizers(n_fft, hop, comp_type, plain)
    noisy = noisy_signal.float().contiguous()
    b = noisy.shape[0]
    orig_spec = stft_fn(noisy, n_fft, hop, comp_type=comp_type)
    audio = noisy
    for k, n, c1, c2, c3, dbar_sqrt, t_frac in _reverse_steps(schedule):
        spec = stft_fn(audio, n_fft, hop, comp_type=comp_type)
        re, im = model(spec, orig_spec, audio.new_full((b,), t_frac))
        eps = istft_fn(torch.complex(re, im), n_fft, hop, comp_type=comp_type,
                       length=audio.shape[-1])
        if n > 0:
            z = _gaussian(noises, k, audio, generator)
            audio = c1 * audio + c2 * noisy - c3 * eps + dbar_sqrt * z
        else:
            audio = (1.0 - gamma) * (c1 * audio - c3 * eps) + gamma * noisy
    return audio
