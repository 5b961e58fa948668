"""Shared set-up of the port's data-parallel tests (tests/test_torch_parallel.py):
the sizes of tests/distributed_trainstep_common.py (TSCNet(8, 201),
Discriminator(4), B 8, L 2000, dropout 0), and the ranks' side.

Run as a script, this file is one rank of a two-process gloo group on
the CPU::

    python tests/torch_parallel_common.py CASE RANK WORLD PORT INPUT OUTPUT

It joins the group at ``127.0.0.1:PORT``, runs ``CASE`` on its contiguous
rows of the global batch in ``INPUT`` (a ``torch.save`` file the test
writes) and saves what it computed to ``OUTPUT``.  ``cli`` instead runs a
training CLI's ``main`` on the arguments after it, at the CLI tests'
widths: the CLI starts its ranks with ``spawn``, which runs this file
again in each of them, so the widths are patched at import, in every
process that runs it as its main module.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 8, 2000
CHILD_TIMEOUT_S = 120


def make_batch():
    """The batch and labels of tests/distributed_trainstep_common.py."""
    rng = np.random.default_rng(42)
    clean = 0.1 * rng.standard_normal((B, L)).astype(np.float32)
    noisy = clean + 0.02 * rng.standard_normal((B, L)).astype(np.float32)
    q_est = np.linspace(0.4, 0.9, B).astype(np.float32)
    q_clean = np.ones(B, np.float32)
    q_noisy = np.linspace(0.2, 0.5, B).astype(np.float32)
    return clean, noisy, q_est, q_clean, q_noisy


def branch_labels():
    """Labels under which the global Gram matrix of the JAX-initialized
    discriminator at tests/torch_train_common.py's seeds takes the
    ``c . e <= 0`` branch (``w_e < 1``) and rank 0's own rows take the
    other (``w_e = 1``); the test asserts both."""
    rng = np.random.default_rng(11)
    return tuple(rng.uniform(0, 1, B).astype(np.float32) for _ in range(3))


def gan_state(variables: dict, dtype=torch.float32):
    """The port's GAN state (SGD lr 1e-3, disc 2e-3) on ``variables``
    (``{"gen", "disc"}`` state_dicts), every dropout rate 0."""
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import create_gan_state

    gen = TSCNet(8, 201, device="cpu")
    gen.load_state_dict(variables["gen"])
    for m in gen.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    disc = Discriminator(4, dropout=0.0, device="cpu")
    disc.load_state_dict(variables["disc"])
    return create_gan_state(gen.to(dtype), disc.to(dtype), "sgd", 1e-3)


def run_gan_steps(variables: dict, clean, noisy, q_est, q_clean, q_noisy,
                  dtype=torch.float32) -> dict:
    """One scp generator step and one self-correcting discriminator step on
    these rows (of this rank), in ``dtype``: the losses, both steps' gradients as the
    optimizers take them, the self-correcting weights (and those of this
    rank's own gradients, before they are averaged), and the new
    state_dicts."""
    from speech_enhancement_tpu_torch.train import gan, l2_loss

    state = gan_state(variables, dtype)
    grads = {}

    def reading(opt, module, tag):
        names = [n for n, _ in module.named_parameters()]
        step = opt.step

        def step_reading_grads():
            grads.update((f"{tag}.{n}", p.grad.clone()) for n, p in zip(names, opt.params))
            step()

        opt.step = step_reading_grads

    reading(state.gen_opt, state.gen, "gen")
    reading(state.disc_opt, state.disc, "disc")
    seen = {}
    real_reduce, real_weights = gan.all_reduce_mean_, gan.self_correcting_weights

    def reduce_recording(tensors):
        tensors = list(tensors)
        if "local_weights" not in seen:  # three gradients, then three losses
            n = (len(tensors) - 3) // 3
            parts = [tensors[i * n:(i + 1) * n] for i in range(3)]
            seen["local_weights"] = torch.stack(
                [w.clone() for w in real_weights(*parts)])
        return real_reduce(tensors)

    def weights_recording(*g):
        w = real_weights(*g)
        seen["weights"] = torch.stack([x.clone() for x in w])
        return w

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    aux = gan.gan_generator_step(state, t(clean), t(noisy), 1, criterion=l2_loss, arch="scp")
    gan.all_reduce_mean_, gan.self_correcting_weights = reduce_recording, weights_recording
    try:
        disc_loss = gan.gan_discriminator_step(state, aux, t(q_est), t(q_clean), t(q_noisy),
                                               2, criterion=l2_loss, arch="scp")
    finally:
        gan.all_reduce_mean_, gan.self_correcting_weights = real_reduce, real_weights
    return {"metrics": {k: float(v) for k, v in aux.metrics.items()},
            "disc_loss": float(disc_loss), "grads": grads, **seen,
            "gen": state.gen.state_dict(), "disc": state.disc.state_dict()}


def diffusion_models():
    """A DiffuSE (16 channels, 4 layers, cycle 2) and a DiffusionTSCNet(8)
    with seeded weights, every parameter moved off its initial value
    (DiffuSE's output conv starts at zero), and every dropout rate 0."""
    from speech_enhancement_tpu_torch.models import DiffuSE, DiffusionTSCNet

    g = torch.Generator().manual_seed(7)
    models = {"diffuse": DiffuSE(dilation_cycle_length=2, residual_channels=16,
                                 residual_layers=4, device="cpu", generator=g),
              "tsc": DiffusionTSCNet(8, 201, 50, device="cpu", generator=g)}
    with torch.no_grad():
        for model in models.values():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = 0.0
    return models


def diffusion_draws(seed: int = 3):
    """Fixed timesteps and noise for the global batch."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 50, B)),
            torch.from_numpy(rng.standard_normal((B, L)).astype(np.float32)))


def run_diffusion_steps(variables: dict, clean, noisy, t, noise,
                        dtype=torch.float64) -> dict:
    """One ``diffuse_step`` and one ``tsc_diffusion_step`` (SGD lr 1e-3) in
    ``dtype`` on these rows with these draws: the losses, the gradients as the
    optimizer takes them, DiffuSE's returned gradient norm and the new
    state_dicts."""
    from speech_enhancement_tpu_torch.train import (
        ModuleState,
        build_optimizer,
        diffuse_step,
        l1_loss,
        linear_noise_schedule,
        tsc_diffusion_step,
    )

    models = diffusion_models()
    out = {}
    sched = linear_noise_schedule(50).astype(np.float32)
    clean, noisy, noise = (torch.as_tensor(a).to(dtype) for a in (clean, noisy, noise))
    for name, model in models.items():
        model.load_state_dict(variables[name])
        model.to(dtype)
        state = ModuleState(model, build_optimizer("sgd", 1e-3, model))
        grads = {}
        names = [n for n, _ in model.named_parameters()]
        step = state.opt.step

        def step_reading_grads(names=names, grads=grads, step=step, state=state):
            grads.update((n, p.grad.clone()) for n, p in zip(names, state.opt.params))
            step()

        state.opt.step = step_reading_grads
        if name == "diffuse":
            loss, norm = diffuse_step(state, clean, noisy, sched, 0, criterion=l1_loss,
                                      t=t, noise=noise, return_grad_norm=True)
            out["diffuse_norm"] = float(norm)
        else:
            loss = tsc_diffusion_step(state, clean, noisy, sched, 0, t=t, noise=noise)
        out[name] = {"loss": float(loss), "grads": grads, "state": model.state_dict()}
    return out


def run_stop(rank: int) -> dict:
    """``run_gan_epoch`` over three batches in which rank 1's ``on_step``
    asks to stop after the first step."""
    from speech_enhancement_tpu_torch.data import Batch
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import create_gan_state, l2_loss, run_gan_epoch

    state = create_gan_state(TSCNet(8, 201, device="cpu"), Discriminator(4, device="cpu"))
    clean, noisy, _, q_clean, q_noisy = make_batch()
    rows = slice(2 * rank, 2 * rank + 2)
    batches = [Batch(clean[rows], noisy[rows], q_clean[rows], q_noisy[rows])] * 3
    stats = run_gan_epoch(state, batches, epoch=0, seed=0, criterion=l2_loss,
                          step_mode="two-phase", gan_active=False,
                          on_step=lambda idx, stats: rank == 1)
    return {"stopped": stats.stopped, "steps": len(stats.gen_losses)}


def rank_main(case: str, rank: int, world: int, port: int, inputs: str, output: str) -> None:
    from speech_enhancement_tpu_torch.parallel import destroy, init_distributed, shard_rows

    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, "cpu", timeout_s=CHILD_TIMEOUT_S)
    try:
        data = torch.load(inputs, weights_only=False) if inputs != "-" else {}
        if case == "batchnorm":
            out = run_batchnorm(shard_rows(data["x"]), shard_rows(data["g"]))
        elif case == "gan":
            rows = [shard_rows(a) for a in data["batch"]]
            out = {dtype: run_gan_steps(data["variables"], *rows, dtype=dtype)
                   for dtype in (torch.float32, torch.float64)}
        elif case == "diffusion":
            out = run_diffusion_steps(data["variables"], *(shard_rows(a) for a in data["batch"]))
        elif case == "stop":
            out = run_stop(rank)
        else:
            raise ValueError(case)
    finally:
        destroy()
    torch.save(out, output)


def run_batchnorm(x: torch.Tensor, g: torch.Tensor) -> dict:
    """The port's BatchNorm1d (16 channels) in train mode on these rows: the
    output, the batch statistics, the running statistics and the gradient
    of ``sum(y * g)`` with respect to the input."""
    from speech_enhancement_tpu_torch.models import layers

    bn = layers.BatchNorm1d(x.shape[1])
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * g).sum().backward()
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        var, mean = layers._global_moments(x.detach())
    else:
        var, mean = torch.var_mean(x.detach(), dim=(0, 2), correction=0)
    return {"y": y.detach(), "grad": x.grad, "mean": mean, "var": var,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def start_ranks(case: str, tmp_path, data: dict | None = None, world: int = 2) -> list:
    """Start ``world`` ranks of ``case`` as processes of this file (inputs
    ``data``); :func:`collect` waits for them."""
    from speech_enhancement_tpu_torch.parallel import free_port

    inputs = "-"
    if data is not None:
        inputs = str(tmp_path / f"{case}_in.pt")
        torch.save(data, inputs)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, case, str(r), str(world), str(port),
                               inputs, str(tmp_path / f"{case}_{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    return procs


def collect(procs, case: str, tmp_path) -> list[dict]:
    """Wait for :func:`start_ranks`' processes (each with its own timeout;
    one that hangs is killed and fails the test) and load their outputs."""
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"rank {r} of {case} hung past {CHILD_TIMEOUT_S} s")
        if p.returncode:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    return [torch.load(tmp_path / f"{case}_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run_cli(module: str, argv: list[str], cwd) -> subprocess.CompletedProcess:
    """``module``'s ``main(argv)`` (a training CLI) in a fresh interpreter
    running this file, at the CLI tests' widths."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, __file__, "cli", module, *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=3 * CHILD_TIMEOUT_S)


def _small_cli_models() -> None:
    """The CLI tests' widths: TSCNet(8), Discriminator(4), DiffusionTSCNet(8)
    and DiffuSE(16 channels, 4 layers)."""
    from speech_enhancement_tpu_torch.cli import main_diffuse, main_gan
    from speech_enhancement_tpu_torch.models import DiffusionTSCNet, Discriminator, TSCNet

    torch.set_num_threads(1)
    main_gan.TSCNet = lambda num_channel, num_features, **kw: TSCNet(8, num_features, **kw)
    main_gan.Discriminator = lambda ndf, **kw: Discriminator(4, **kw)
    real = main_diffuse.build_model

    def build(args, config, device=None):
        if args.arch == "diffuse":
            return real(args, config, device)
        return DiffusionTSCNet(8, config.N_FFT // 2 + 1, len(config.NOISE_SCHEDULE),
                               device=device, generator=torch.Generator().manual_seed(0))

    main_diffuse.build_model = build


if __name__ in ("__main__", "__mp_main__") and len(sys.argv) > 1 and sys.argv[1] == "cli":
    _small_cli_models()

if __name__ == "__main__":
    if sys.argv[1] == "cli":
        import importlib

        importlib.import_module(f"speech_enhancement_tpu_torch.cli.{sys.argv[2]}").main(
            sys.argv[3:])
    else:
        case, rank, world, port, inputs, output = sys.argv[1:7]
        rank_main(case, int(rank), int(world), int(port), inputs, output)
