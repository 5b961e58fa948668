"""Plain SCP-GAN training, followed for the first steps of a run: the data
pipeline's crops and PESQ labels, the step seeds, the generator's losses
and gradients, the deferred discriminator updates of the step mode, the
self-correcting discriminator step, SGD with Nesterov momentum and weight
decay, the cyclic cosine schedule and the spectral-norm refresh.

The semantics are those of ``cli.main_gan -a scp`` (the reference
minyoungpark1/Speech-Enhancement, ``config/scp.yaml``) as the program
states them: the loader shuffles by (seed, epoch) and crops batch ``b``
with a generator keyed (seed, epoch, 0, b), retrying a crop that PESQ
finds silent; step ``i`` of epoch ``e`` draws its dropout from the seed
(seed, e, i); the discriminator's update of a step is applied ``lag``
steps later, on the current discriminator.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from scipy.io import wavfile

from sebench.reference import dsp, pesq


# ---------------------------------------------------------------- data

def read_wav(path: str) -> np.ndarray:
    _, data = wavfile.read(path)
    return data.astype(np.float32) / 32768.0


def crops(pairs: list[tuple[str, str]], *, seed: int, epoch: int, batch: int,
          batch_size: int, crop: int):
    """(clean, noisy) ``[B, crop]`` of batch ``batch``: each record cut at a
    start drawn from the batch's generator (tiled when shorter), up to ten
    draws until PESQ finds the crop not silent."""
    idx = np.arange(len(pairs))
    np.random.default_rng((seed, epoch)).shuffle(idx)
    rng = np.random.default_rng(np.random.SeedSequence((seed, epoch, 0, batch)))
    cleans, noisys = [], []
    for i in idx[batch * batch_size:(batch + 1) * batch_size]:
        clean, noisy = (read_wav(p) for p in pairs[int(i)])
        for _ in range(10):
            if len(clean) < crop:
                c, n = np.resize(clean, crop), np.resize(noisy, crop)
            else:
                start = int(rng.integers(0, len(clean) - crop + 1))
                c, n = clean[start:start + crop], noisy[start:start + crop]
            if pesq.pesq_batch(c[None], n[None])[0] != -1:
                cleans.append(c)
                noisys.append(n)
                break
    return np.stack(cleans), np.stack(noisys)


def label(clean: np.ndarray, other: np.ndarray) -> np.ndarray:
    """Normalized PESQ labels ``(pesq - 1) / 3.5``."""
    return ((pesq.pesq_batch(clean, other) - 1.0) / 3.5).astype(np.float32)


# ------------------------------------------------------------ schedule

def step_seed(seed: int, epoch: int, index: int) -> int:
    return int(np.random.SeedSequence((seed, epoch, index)).generate_state(1)[0])


def phase_seeds(seed: int) -> tuple[int, int]:
    a, b = np.random.SeedSequence(seed).generate_state(2)
    return int(a), int(b)


def cyclic_cosine(step: int, base_lr: float, epochs: int, iters: int, cycle_limit: int,
                  warmup_epochs: int) -> float:
    """Warmup then a half cosine within each of ``cycle_limit`` cycles, each
    cycle at half the last one's height."""
    cycle = max(epochs // cycle_limit, 1)
    warmup = min(warmup_epochs, cycle - 1) if cycle > 1 else 0
    epoch = step / float(iters)
    q = math.floor(epoch / cycle)
    r = epoch - q * cycle
    if r < warmup:
        return 0.5 ** q * base_lr * r / warmup
    return base_lr * 0.5 ** (q + 1) * (1.0 + math.cos(math.pi * (r - warmup)
                                                      / max(cycle - warmup, 1e-9)))


def decays(name: str, param: torch.Tensor) -> bool:
    """Weight decay on matrices and kernels, not on vectors or biases."""
    return param.ndim > 1 and not any(p.endswith("bias") for p in name.split("."))


class SGD:
    """SGD with Nesterov momentum and decoupled-free (L2) weight decay:
    d = g + wd p; m = d (first step) or mu m + d; p -= lr (d + mu m)."""

    def __init__(self, module, momentum: float, weight_decay: float):
        self.named = list(module.named_parameters())
        self.momentum, self.wd = momentum, weight_decay
        self.buf: dict[str, torch.Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: float) -> None:
        for (name, p), g in zip(self.named, grads):
            d = g + self.wd * p if decays(name, p) else g
            m = self.buf.get(name)
            m = d.clone() if m is None else m * self.momentum + d
            self.buf[name] = m
            p -= lr * (d + self.momentum * m)
        self.count += 1


# --------------------------------------------------------------- steps

def mse(a, b):
    return torch.mean((a - b) ** 2)


def generator_losses(gen, disc, clean, noisy, *, n_fft, hop, power, weights, gan_active):
    """(total loss, aux) of the SCP generator step on raw ``[B, L]`` audio."""
    gain = dsp.rms_gain(noisy)
    clean, noisy = clean * gain, noisy * gain
    length = clean.shape[-1]
    n_re, n_im = dsp.compressed_stft(noisy, n_fft, hop, power)
    c_re, c_im = dsp.compressed_stft(clean, n_fft, hop, power)
    e_re, e_im = gen(n_re, n_im)
    est_mag = torch.sqrt(e_re ** 2 + e_im ** 2)
    clean_mag = torch.sqrt(c_re ** 2 + c_im ** 2)
    est_audio = dsp.uncompressed_istft(e_re, e_im, n_fft, hop, power, length)
    # consistency: the re-featurized estimate against the clean spectrum's
    # iSTFT -> STFT round trip
    ep_re, ep_im = dsp.compressed_stft(est_audio, n_fft, hop, power)
    clean_prime = dsp.uncompressed_istft(c_re, c_im, n_fft, hop, power, length)
    cp_re, cp_im = dsp.compressed_stft(clean_prime, n_fft, hop, power)
    loss_mag = mse(torch.sqrt(ep_re ** 2 + ep_im ** 2), torch.sqrt(cp_re ** 2 + cp_im ** 2))
    time_loss = torch.mean(torch.abs(est_audio - clean_prime))
    loss_ri = mse(ep_re, cp_re) + mse(ep_im, cp_im)
    total = weights[0] * loss_ri + weights[1] * loss_mag + weights[2] * time_loss
    if gan_active:
        d_fake = disc(clean_mag, est_mag).reshape(-1)
        total = total + weights[3] * mse(d_fake, torch.ones_like(d_fake))
    aux = dict(est_audio=est_audio.detach(), est_mag=est_mag.detach(),
               clean_mag=clean_mag.detach(),
               noisy_mag=torch.sqrt(n_re ** 2 + n_im ** 2).detach())
    return total, aux


def sc_weights(gram: torch.Tensor) -> torch.Tensor:
    """SCP-GAN's combination weights [w_c, w_e, w_n] from the 3x3 Gram
    matrix of the clean, estimate and noisy terms' gradients."""
    c_e, c_n, e_n = gram[0, 1], gram[0, 2], gram[1, 2]
    e_e, n_n = gram[1, 1] + 1e-14, gram[2, 2] + 1e-14
    one = torch.ones((), dtype=gram.dtype, device=gram.device)
    w_e = torch.where(c_e > 0, one, -c_e / e_e)
    s = c_n + w_e * e_n
    w_n_pos = -(c_n + e_n) / n_n
    w_n_neg = -c_n / n_n + c_e * e_n / (e_e * n_n)
    w_n = torch.where(s > 0, one, torch.where(c_e > 0, w_n_pos, w_n_neg))
    return torch.stack([one, w_e, w_n])


def discriminator_grads(disc, aux, q_est, q_clean, q_noisy):
    """(combined gradients, loss, weights) of the self-correcting three-term
    step."""
    params = list(disc.parameters())
    clean_mag = aux["clean_mag"]
    losses, grads = [], []
    for other, lab in ((clean_mag, q_clean), (aux["est_mag"], q_est),
                       (aux["noisy_mag"], q_noisy)):
        loss = mse(disc(clean_mag, other).reshape(-1), lab)
        losses.append(loss.detach())
        grads.append(torch.autograd.grad(loss, params))
    flat = torch.stack([torch.cat([g.reshape(-1) for g in gs]) for gs in grads])
    w = sc_weights(flat @ flat.T)
    combined = [w[0] * a + w[1] * b + w[2] * c for a, b, c in zip(*grads)]
    return combined, torch.dot(w, torch.stack(losses)), w


@contextlib.contextmanager
def seeded(seed: int, device: torch.device):
    """The global generators seeded from ``seed`` inside, restored after."""
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        yield


def follow(gen, disc, pairs, *, cfg: dict, steps: int, lag: int, gan_active: bool,
           loader_seed: int, step_seed_base: int, epoch: int, gen_count: int,
           disc_count: int, iters: int, device: torch.device) -> dict:
    """The first ``steps`` steps of an epoch from the models' present
    weights.  Returns each step's generator loss, each applied
    discriminator update's loss, the first gradient of each model as its
    optimizer gets it, and the models' parameters after the steps; for
    the look at where two runs part (``calibrate.py --diagnose``), the
    generator's parameters after each step, each step's labels and each
    applied update's self-correcting weights."""
    tr = cfg["training"]
    crop = cfg["hop"] * tr["crop_frames"] * tr["crop_len"]
    kw = dict(n_fft=cfg["n_fft"], hop=cfg["hop"], power=cfg["compress_power"],
              weights=tr["loss_weights"], gan_active=gan_active)
    gen_opt = SGD(gen, tr["momentum"], tr["weight_decay"])
    disc_opt = SGD(disc, tr["momentum"], tr["weight_decay"])
    gen_opt.count, disc_opt.count = gen_count, disc_count

    def lr(count: int, scale: float) -> float:
        return scale * cyclic_cosine(count, tr["lr"], tr["epochs"], iters, tr["cycle_limit"],
                                     tr["warmup_epochs"])

    out = dict(gen_losses=[], disc_losses=[], gen_grads=None, disc_grads=None,
               gen_step_params=[], labels=[], sc_weights=[])
    pending = []

    def apply_oldest():
        aux, q_est, q_clean, q_noisy, seed_disc = pending.pop(0)
        disc.train()
        with seeded(seed_disc, device):
            grads, loss, weights = discriminator_grads(disc, aux, q_est, q_clean, q_noisy)
        out["sc_weights"].append(weights.tolist())
        if out["disc_grads"] is None:
            out["disc_grads"] = {n: g.detach().clone()
                                 for (n, _), g in zip(disc.named_parameters(), grads)}
        out["disc_losses"].append(float(loss))
        disc_opt.step(grads, lr(disc_opt.count, tr["disc_lr_scale"]))
        disc.refresh_()

    for index in range(steps):
        clean_np, noisy_np = crops(pairs, seed=loader_seed, epoch=epoch, batch=index,
                                   batch_size=tr["batch_size"], crop=crop)
        q_clean = torch.as_tensor(label(clean_np, clean_np), device=device)
        q_noisy = torch.as_tensor(label(clean_np, noisy_np), device=device)
        clean = torch.as_tensor(clean_np, device=device)
        noisy = torch.as_tensor(noisy_np, device=device)
        seed_gen, seed_disc = phase_seeds(step_seed(step_seed_base, epoch, index))
        if lag and len(pending) >= lag:
            apply_oldest()
        gen.train()
        disc.train()
        names, params = zip(*gen.named_parameters())
        with seeded(seed_gen, device):
            total, aux = generator_losses(gen, disc, clean, noisy, **kw)
            grads = torch.autograd.grad(total, params)
        if out["gen_grads"] is None:
            out["gen_grads"] = {n: g.detach().clone() for n, g in zip(names, grads)}
        out["gen_losses"].append(float(total.detach()))
        gen_opt.step(grads, lr(gen_opt.count, 1.0))
        out["gen_step_params"].append({n: p.detach().clone() for n, p in gen.named_parameters()})
        labels = dict(clean_sum=float(clean_np.sum(dtype=np.float64)),
                      q_clean=q_clean.tolist(), q_noisy=q_noisy.tolist())
        out["labels"].append(labels)
        if gan_active:
            est = aux["est_audio"].cpu().numpy()
            q_est = torch.as_tensor(label(clean_np[:, :est.shape[1]], est), device=device)
            labels["q_est"] = q_est.tolist()
            pending.append((aux, q_est, q_clean, q_noisy, seed_disc))
            if not lag:
                apply_oldest()
    out["gen_params"] = {n: p.detach().clone() for n, p in gen.named_parameters()}
    out["disc_params"] = {n: p.detach().clone() for n, p in disc.named_parameters()}
    return out
