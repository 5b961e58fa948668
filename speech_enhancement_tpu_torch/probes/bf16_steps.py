#!/usr/bin/env python3
"""Repeat the bf16 training steps of ``chip_smoke.py`` phase 7 from its seed
and report where each step's gradient comes from.

    python3 speech_enhancement_tpu_torch/probes/bf16_steps.py [--repeats 12] [--root DIR]

``--root`` is the checkout whose ``speech_enhancement_tpu_torch`` is run
(default: the one this file is in), so that this one file also runs an
older tree; the phase-7 helpers come from the ``chip_smoke.py`` beside this
file's package.  Each repeat builds phase 7's state anew
(``TSCNet(64, 201, fused_attention=True)``, ``Discriminator(16)``,
SGD-Nesterov lr 0.01) and takes phase 7's three bf16 steps of
``make_fused_gan_train_step`` on its first batch.  Per step it prints each
loss term and ``disc_loss``, the self-correcting weights ``w_c, w_e, w_n``
and the Gram entries they come from (``chip_smoke.sc_step_text``), the
norms of the discriminator's gradient and of the generator's with its
three largest parameter gradients, and, at the DSP of the scp losses:

* ``spec``: the generator's (compressed) output spectrum: largest
  magnitude, largest gradient;
* ``audio``: the iSTFT of its uncompression (``|z|^(1/0.3)``): largest
  sample, largest gradient;
* ``restft``: the compressed re-STFT of that audio: smallest magnitude
  ``|X|^0.3`` (the compression's gradient grows as ``|X|^-0.7`` towards an
  empty bin), largest gradient.

A repeat whose third loss is not below its first, as phase 7 checks, is
marked DIVERGED.  The last line is a JSON summary.  A blow-up that comes
once in many processes is sought with many processes, each with
``--repeats 1`` or a few: repeats inside one process have not shown it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=12)
    parser.add_argument("--root", type=Path, default=HERE)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from speech_enhancement_tpu_torch.models import Discriminator, TSCNet
    from speech_enhancement_tpu_torch.train import (
        create_gan_state,
        gan,
        l2_loss,
        make_fused_gan_train_step,
    )

    if not torch.cuda.is_available():
        print("bf16_steps: no CUDA device", file=sys.stderr)
        return 1
    cs.full_fp32()  # as chip_smoke.main sets it
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)

    rec: dict = {}

    def note(name, t, reduce):
        rec[name] = {"value": reduce(t.detach().abs()), "grad": None}
        t.register_hook(lambda g: rec[name].__setitem__("grad", g.abs().max()))

    istft, stft = gan.uncompressed_istft, gan.compressed_stft

    def traced_istft(spec, *a, **kw):
        out = istft(spec, *a, **kw)
        if spec.requires_grad and "spec" not in rec:
            note("spec", spec, torch.max)
            note("audio", out, torch.max)
        return out

    def traced_stft(signal, *a, **kw):
        out = stft(signal, *a, **kw)
        if signal.requires_grad and "restft" not in rec:
            note("restft", out, torch.min)
        return out

    gan.uncompressed_istft, gan.compressed_stft = traced_istft, traced_stft

    clean, noisy = cs.make_batches(np.random.default_rng(cs.SEED), 1)[0]
    step = make_fused_gan_train_step(criterion=l2_loss, arch="scp", compute_dtype=torch.bfloat16)
    tag = f"{args.label} " if args.label else ""
    summary = []
    for r in range(args.repeats):
        gen_model = TSCNet(64, 201, fused_attention=True, remat=True, device="cuda",
                           generator=torch.Generator().manual_seed(cs.SEED))
        disc = Discriminator(16, device="cuda",
                             generator=torch.Generator().manual_seed(cs.SEED + 1))
        state = create_gan_state(gen_model, disc, "sgd", 0.01, momentum=0.9, weight_decay=0.01)
        grads = cs.read_grads(state.gen_opt, state.gen)
        disc_grads = cs.read_grads(state.disc_opt, state.disc)
        steps = []
        for i in range(3):
            rec.clear()
            with cs.sc_weight_trace() as sc:
                raw = step(state, clean, noisy, i)
            (gram, w), = sc
            metrics = {k: float(v) for k, v in raw.items()}
            norms = {n: float(g.double().norm()) for n, g in grads.items()}
            disc_norm = float(np.sqrt(sum(float(g.double().norm()) ** 2
                                          for g in disc_grads.values())))
            top = sorted(norms, key=norms.get, reverse=True)[:3]
            dsp = {name: (float(v["value"]), float(v["grad"])) for name, v in rec.items()}
            total = float(np.sqrt(sum(x * x for x in norms.values())))
            steps.append({**metrics, "grad_norm": total, "disc_grad_norm": disc_norm,
                          "weights": [float(x) for x in w],
                          "gram": [[float(x) for x in row] for row in gram.double().cpu()],
                          "dsp": dsp, "top": {n: norms[n] for n in top}})
            print(f"{tag}repeat {r} step {i}: {cs.sc_step_text(raw, gram, w, disc_norm)}; "
                  f"generator |grad| {total:.4g}, largest "
                  + ", ".join(f"{n} {norms[n]:.3g}" for n in top)
                  + "; spec max {:.4g} grad {:.3g}; audio max {:.4g} grad {:.3g}; restft "
                  "min {:.3g} grad {:.3g}".format(*dsp["spec"], *dsp["audio"], *dsp["restft"]),
                  flush=True)
        diverged = not steps[-1]["loss"] < steps[0]["loss"]
        if diverged:
            print(f"{tag}repeat {r} DIVERGED", flush=True)
        summary.append({"diverged": diverged, "steps": steps})
        del state, gen_model, disc, grads, disc_grads
    n_div = sum(s["diverged"] for s in summary)
    print(f"{tag}{n_div} of {args.repeats} repeats diverged", flush=True)
    print(json.dumps({"label": args.label, "repeats": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
