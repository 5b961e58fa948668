"""SCP-GAN training as ``cli.main_gan -a scp --cfg .../scp.yaml`` runs it,
on a synthetic corpus written as wavs under ``TMPDIR``: the port's
``DataLoader(VoicebankDataset, Collator(precompute_labels=True))`` feeds
``run_gan_epoch`` in the configuration's step mode, with the PESQ label
threads and deferred discriminator updates running.  The run resumes at
``start_epoch`` (the optimizers' update counts of that epoch, so the
schedule's learning rate is that epoch's; their momentum starts empty).
``gan_active`` false gives the generator-only epochs of ``--gen-first``.

The first ``compare_steps`` steps are followed by the plain reference
once the window has closed; the first ``warmup_steps`` steps (those among
them) are set-up.  The window then runs whole steps, closed through the
``on_step`` hook at the first step that ends after ``--seconds``.

End to end: ``train_audio_rate`` (rows x crop seconds of the window's
steps over its wall time) and ``train_peak_gib`` (the device's peak
allocation over the window).  Counters: the window's steps, the seconds
the loop waited on the loader's ``next()`` (the benchmark's own span) and
on the estimate's labels (``EpochStats.label_wait``).
"""

from __future__ import annotations

import itertools
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sebench import training, weights
from sebench.harness import GIB
from sebench.reference import train as ref_train
from sebench.reference.models import Discriminator as RefDiscriminator
from sebench.reference.models import TSCNet as RefTSCNet
from sebench.reference.precision import ieee_fp32


def run(bench) -> None:
    root = tempfile.mkdtemp(prefix="sebench-corpus-")
    try:
        _run(bench, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(bench, root: str) -> None:
    from speech_enhancement_tpu_torch.data import Collator, DataLoader, VoicebankDataset
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import (
        DISC_LAG,
        GanTrainState,
        build_criterion,
        build_optimizer,
        cyclic_cosine_schedule,
        run_gan_epoch,
    )

    cfg, tr, p, dev = bench.config, bench.config["training"], bench.params, bench.device
    gan_active = bool(p["gan_active"])
    precision = p.get("precision") or tr["precision"]
    clean_dir, noisy_dir, pairs = training.write_corpus(bench, root)

    init = {"gen": weights.seeded_state(RefTSCNet(cfg["num_channel"], cfg["num_features"]),
                                        bench.seed_of("generator"), dev),
            "disc": weights.seeded_state(RefDiscriminator(cfg["ndf"]),
                                         bench.seed_of("discriminator"), dev)}
    gen = TSCNet(cfg["num_channel"], cfg["num_features"],
                 fused_attention=tr["fused_attention"], device=dev)
    disc = Discriminator(cfg["ndf"], device=dev)
    gen.load_state_dict(init["gen"])
    disc.load_state_dict(init["disc"])
    params0 = {m: {n: init[m][n] for n, _ in mod.named_parameters()}
               for m, mod in (("gen", gen), ("disc", disc))}

    hop, crop_frames, crop_len = cfg["hop"], tr["crop_frames"], tr["crop_len"]
    loader_seed, steps_seed = bench.seed_of("loader"), bench.seed_of("steps")
    loader = DataLoader(VoicebankDataset(clean_dir, noisy_dir, hop, crop_frames),
                        tr["batch_size"],
                        Collator(hop, crop_frames, crop_len, rng=np.random.default_rng(loader_seed),
                                 precompute_labels=True, sample_rate=cfg["sample_rate"]),
                        shuffle=True, seed=loader_seed, num_workers=tr["workers"])
    iters = len(loader)
    gen_opt, disc_opt = (
        build_optimizer(tr["optimizer"],
                        cyclic_cosine_schedule(tr["lr"], tr["epochs"], iters, tr["cycle_limit"],
                                               tr["warmup_epochs"], scale=scale),
                        model, tr["momentum"], tr["weight_decay"], tr["max_norm"])
        for scale, model in ((1.0, gen), (tr["disc_lr_scale"], disc)))
    state = GanTrainState(gen, disc, gen_opt, disc_opt)
    start_epoch = p["start_epoch"]
    state.epoch = start_epoch
    gen_opt.count = start_epoch * iters
    disc_opt.count = start_epoch * iters if gan_active else 0
    counts0 = (gen_opt.count, disc_opt.count)
    lag = DISC_LAG[tr["step_mode"]]
    label_pool = ThreadPoolExecutor(max_workers=max(1, lag))

    program: dict = {}
    clock = dict(steps=0, done=0, data_wait=0.0, label_wait=0.0, label_base=0.0, start=0.0)

    def on_step(idx, stats):
        clock["done"] += 1
        done = clock["done"]
        if done == 1:
            program["gen_grads"] = training.first_gradients(gen_opt, gen, params0["gen"])
        if done == p["compare_steps"]:
            program["gen_losses"] = list(stats.gen_losses[:done])
            program["disc_losses"] = list(stats.disc_losses)
            program["disc_grads"] = training.first_gradients(disc_opt, disc, params0["disc"])
            for m, mod in (("gen", gen), ("disc", disc)):
                program[f"{m}_params"] = {n: t.detach().clone() for n, t in mod.named_parameters()}
        if done == p["warmup_steps"]:
            bench.setup_done()
            clock["start"] = bench.open_window()
            clock["label_base"] = clock["label_wait"] + stats.label_wait
            return False
        if bench.window_open:
            clock["steps"] += 1
            if time.perf_counter() - clock["start"] >= bench.seconds:
                clock["label_wait"] += stats.label_wait
                return True
        return False

    def timed(batches):
        it = iter(batches)
        try:
            while True:
                t = time.perf_counter()
                with torch.profiler.record_function("sebench.data_wait"):
                    batch = next(it, None)
                if bench.window_open:
                    clock["data_wait"] += time.perf_counter() - t
                if batch is None:
                    return
                yield batch
        finally:
            it.close()

    losses = []
    try:
        for epoch in itertools.count(start_epoch):
            loader.set_epoch(epoch)
            batches = timed(loader)
            stats = run_gan_epoch(
                state, batches, epoch=epoch, seed=steps_seed, criterion=build_criterion(tr["criterion"]),
                step_mode=tr["step_mode"], arch=tr["arch"], comp_type=tr["comp_type"],
                n_fft=cfg["n_fft"], hop=hop, gan_active=gan_active,
                loss_weights=tuple(tr["loss_weights"]),
                compute_dtype=torch.bfloat16 if precision == "bf16" else None,
                sample_rate=cfg["sample_rate"], label_pool=label_pool, on_step=on_step)
            batches.close()
            losses += stats.gen_losses
            if stats.stopped:
                break
            clock["label_wait"] += stats.label_wait
        window = bench.close_window()
    finally:
        label_pool.shutdown(wait=True, cancel_futures=True)

    rows_s = tr["batch_size"] * crop_frames * crop_len * hop / cfg["sample_rate"]
    bench.e2e["train_audio_rate"] = clock["steps"] * rows_s / window
    bench.e2e["train_peak_gib"] = bench.window_peak / GIB
    bench.attempted = len(losses)
    bench.failed = int(sum(not np.isfinite(x) for x in losses))
    bench.counters.update(steps=clock["steps"], data_wait_s=clock["data_wait"],
                          label_wait_s=clock["label_wait"] - clock["label_base"])

    del state, gen, disc, gen_opt, disc_opt, loader
    if bench.cuda:
        torch.cuda.empty_cache()
    ref_gen = RefTSCNet(cfg["num_channel"], cfg["num_features"], checkpointed=True).to(dev)
    ref_disc = RefDiscriminator(cfg["ndf"]).to(dev)
    ref_gen.load_state_dict(init["gen"])
    ref_disc.load_state_dict(init["disc"])
    with ieee_fp32():
        ref = ref_train.follow(ref_gen, ref_disc, pairs, cfg=cfg, steps=p["compare_steps"],
                               lag=lag, gan_active=gan_active, loader_seed=loader_seed,
                               step_seed_base=steps_seed, epoch=start_epoch,
                               gen_count=counts0[0], disc_count=counts0[1], iters=iters,
                               device=dev)
    training.compare(bench, program, ref, params0, gan_active)
