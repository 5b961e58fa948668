"""How far the fp32 gradients of one diffusion train step are from float64.

Runs ``chip_smoke.py`` phase 10's fp32 step (the same seeded full-width
model, batch 8 x 1 s, draws and SGD state, dropout off) on the card at
IEEE fp32 with cuDNN as torch picks its algorithms, with cuDNN in
deterministic mode, and with cuDNN off (torch's native convolutions), and
on the CPU in fp32 and float64; prints each gradient's relative RMS from
the CPU's float64 one, and the leaves that carry most of the card's
difference from the CPU's fp32.  Run from the repository root on a
machine with a card:

    python3 -m speech_enhancement_tpu_torch.probes.diffusion_grad_floor [--arch tsc-diffuse]
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess

import numpy as np
import torch

from speech_enhancement_tpu_torch.train import (
    ModuleState,
    build_optimizer,
    diffuse_step,
    l1_loss,
    linear_noise_schedule,
    tsc_diffusion_step,
)


def step_grads(arch: str, device: str, dtype: torch.dtype, batch, t, noise) -> dict:
    import chip_smoke as cs

    model = cs.no_dropout(cs.diffusion_models(device)[arch]).to(dtype)
    state = ModuleState(model, build_optimizer("sgd", 1e-3, model))
    grads = cs.read_grads(state.opt, model)
    clean, noisy = (x.to(device, dtype) for x in batch)
    kw = dict(t=t.to(device), noise=noise.to(device, dtype))
    betas = linear_noise_schedule(50)
    if arch == "diffuse":
        loss = diffuse_step(state, clean, noisy, betas, 0, criterion=l1_loss, **kw)
    else:
        loss = tsc_diffusion_step(state, clean, noisy, betas, 0, **kw)
    print(f"  {arch} {device} {dtype}: loss {float(loss):.9g}", flush=True)
    return {k: g.double().cpu() for k, g in grads.items()}


def flat(grads: dict) -> torch.Tensor:
    return torch.cat([grads[k].reshape(-1) for k in sorted(grads)])


@contextlib.contextmanager
def cudnn(**flags):
    saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(torch.backends.cudnn, k, v)


def main(argv=None) -> None:
    import chip_smoke as cs

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="tsc-diffuse", choices=["diffuse", "tsc-diffuse"])
    args = parser.parse_args(argv)
    cs.full_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    batch = [x.cpu() for x in cs.make_batches(np.random.default_rng(cs.SEED + 13), 1)[0]]
    draws = torch.Generator().manual_seed(cs.SEED + 14)
    t = torch.randint(0, 50, batch[0].shape[:1], generator=draws)
    noise = torch.randn(batch[0].shape, generator=draws)
    runs = {"card, cuDNN": step_grads(args.arch, "cuda", torch.float32, batch, t, noise)}
    with cudnn(deterministic=True):
        runs["card, cuDNN deterministic"] = step_grads(args.arch, "cuda", torch.float32, batch,
                                                       t, noise)
    with cudnn(enabled=False):
        runs["card, cuDNN off"] = step_grads(args.arch, "cuda", torch.float32, batch, t, noise)
    runs["CPU fp32"] = step_grads(args.arch, "cpu", torch.float32, batch, t, noise)
    exact = step_grads(args.arch, "cpu", torch.float64, batch, t, noise)
    want = flat(exact)
    for name, grads in runs.items():
        print(f"{name}: gradients' relative RMS from the CPU's float64 step "
              f"{cs.rel_rms_t(flat(grads), want):.3e}; from the CPU's fp32 step "
              f"{cs.rel_rms_t(flat(grads), flat(runs['CPU fp32'])):.3e} ({card})", flush=True)
    diff = {k: float((runs["card, cuDNN"][k] - runs["CPU fp32"][k]).pow(2).sum()) for k in exact}
    total = sum(diff.values())
    for k in sorted(diff, key=diff.get, reverse=True)[:10]:
        print(f"  {diff[k] / total:.3f} of the card-CPU difference: {k} (card from float64 "
              f"{cs.rel_rms_t(runs['card, cuDNN'][k], exact[k]):.2e}, CPU fp32 from float64 "
              f"{cs.rel_rms_t(runs['CPU fp32'][k], exact[k]):.2e})", flush=True)


if __name__ == "__main__":
    main()
