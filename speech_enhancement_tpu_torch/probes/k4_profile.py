"""Which route the |STFT| conditioner of ``cdiffuse_inference.predict``
takes on the card, by its output and by ``torch.profiler``.

Saves a full-width standalone-CDiffuSE ``DiffuSE`` of seeded weights
(``chip_smoke.cdiffuse_model``) as a checkpoint directory, then on one
utterance of 4 s:

* the conditioner itself: ``fused_stft`` (K4, ``comp_type='none'``) against
  ``stft_reference`` on the same card tensor (max abs difference: zero only
  if both took one route), and K4's launch count over the call;
* ``predict`` on the same draws with the default route and with
  ``plain=True`` (relative RMS), and K4's launches in each;
* one ``predict`` under ``torch.profiler`` with CUDA activity alone, with
  CPU and CUDA activity, and under ``utils.profiling.trace`` (CPU and
  CUDA, a trace written): the CUDA entries whose names hold ``stft``, and
  the count of CUDA entries; then one ``fused_stft`` call alone under each.

Run from the repository root on a machine with a card:

    python3 -m speech_enhancement_tpu_torch.probes.k4_profile
"""

from __future__ import annotations

import os
import subprocess
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from speech_enhancement_tpu_torch.cli import cdiffuse_inference
from speech_enhancement_tpu_torch.ops import fused_stft as fs
from speech_enhancement_tpu_torch.utils.profiling import trace


def cuda_entries(prof) -> dict:
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profiled(fn, how: str, log_dir: str) -> dict:
    torch.cuda.synchronize()
    before = fs.stft_launches
    if how == "trace":
        ctx = trace(log_dir)
    else:
        activities = [ProfilerActivity.CUDA]
        if how == "cpu+cuda":
            activities.insert(0, ProfilerActivity.CPU)
        ctx = profile(activities=activities)
    with ctx as prof:
        fn()
        torch.cuda.synchronize()
    entries = cuda_entries(prof)
    stft = {k[:70]: v for k, v in entries.items() if "stft" in k}
    return {"K4 launches": fs.stft_launches - before, "CUDA entries": len(entries),
            "stft entries (count, ms)": stft}


def main() -> None:
    import chip_smoke as cs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}", flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="k4_profile_")
    model = cs.cdiffuse_model("cpu", cs.SEED)
    torch.save({"model": model.state_dict()}, os.path.join(tmp.name, "variables.pt"))
    x = (0.3 * np.random.default_rng(cs.SEED + 24).standard_normal(4 * cs.SR)).astype(np.float32)
    x_card = torch.from_numpy(x[None]).cuda()

    before = fs.stft_launches
    kernel = fs.fused_stft(x_card, 400, 100, comp_type="none").abs()
    launched = fs.stft_launches - before
    plain = fs.stft_reference(x_card, 400, 100, comp_type="none").abs()
    print(f"conditioner |STFT| [1, 64000]: fused_stft launched K4 {launched} time(s); max abs "
          f"|fused - reference| {float((kernel - plain).abs().max()):.3e}, max |reference| "
          f"{float(plain.abs().max()):.3e}", flush=True)
    model_route = cdiffuse_inference.conditioner_route(
        cdiffuse_inference.load_model(tmp.name, "cuda")[0])
    print(f"route printed by the CLI: {model_route}", flush=True)

    noises = torch.randn((6, 1, 100 * (len(x) // 100)), generator=torch.Generator().manual_seed(1))
    outs, used = [], []
    for use_plain in (False, True):
        before = fs.stft_launches
        outs.append(cdiffuse_inference.predict(x, tmp.name, fast=True, noises=noises,
                                               plain=use_plain, device="cuda"))
        used.append(fs.stft_launches - before)
    a, b = (np.asarray(o, np.float64) for o in outs)
    print(f"predict, fast, same draws: default route vs plain=True relative RMS "
          f"{float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2))):.3e}, max abs "
          f"{float(np.abs(a - b).max()):.3e}; K4 launches {used[0]} (default), {used[1]} "
          f"(plain)", flush=True)

    for how in ("cuda", "cpu+cuda", "trace"):
        got = profiled(lambda: cdiffuse_inference.predict(x, tmp.name, fast=True,
                                                          device="cuda"),
                       how, os.path.join(tmp.name, f"trace_{how}"))
        print(f"one predict under the profiler ({how}): {got}", flush=True)
        got = profiled(lambda: fs.fused_stft(x_card, 400, 100, comp_type="none"), how,
                       os.path.join(tmp.name, f"trace_k4_{how}"))
        print(f"one fused_stft alone under the profiler ({how}): {got}", flush=True)
    tmp.cleanup()


if __name__ == "__main__":
    main()
