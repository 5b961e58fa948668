"""Readings that the correctness limits are set from: the numbers each
check compares, over many seeds, for the program as the configuration
states it, for the control, and for planted faults.

    python3 -m sebench.calibrate --workload <cell> --seeds 11,12,13 \\
        [--mode program|control|<fault>] [--seconds 3]

``control`` runs the program's own bf16 path in place of the stated
precision (``params.precision = "bf16"``); ``ieee`` runs the program with
its fp32 matmuls and cuDNN convolutions in IEEE fp32, not TF32 (a second
witness: where its readings fall, TF32 rounding made them); a fault name
runs the program with that fault of ``faults.py`` planted.  ``--diagnose``
(training cells) adds where the program and the reference part: each of
the first steps' generator update by leaf, side by side, the labels of
both and the self-correcting weights of both.  One JSON line per seed on
standard output and in ``chiprun_out/calibrate.jsonl``."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def diagnose(record: dict):
    """Records, while active, the generator's parameters before and after
    each of its first three steps, the batches' and the estimates' labels,
    the self-correcting weights, and the reference's own records."""
    from speech_enhancement_tpu_torch.train import gan, loop

    from sebench.reference import train as ref_train

    record.update(gen=[], batches=[], est=[], sc=[], ref=None)
    kept = dict(gen_step=loop.gan_generator_step, to_device=loop._to_device,
                labels=loop.estimate_labels, weights=gan._sc_weights_from_gram,
                follow=ref_train.follow)

    def snap(module):
        return {n: p.detach().clone() for n, p in module.named_parameters()}

    def gen_step(state, *args, **kw):
        first = len(record["gen"]) < 4
        if not record["gen"]:
            record["gen"].append(snap(state.gen))
        aux = kept["gen_step"](state, *args, **kw)
        if first:
            record["gen"].append(snap(state.gen))
        return aux

    calls = []

    def to_device(array, device):
        calls.append(array)
        if len(calls) % 4 == 0 and len(record["batches"]) < 4:
            audio, _, q_clean, q_noisy = calls[-4:]
            record["batches"].append(dict(clean_sum=float(audio.sum(dtype="float64")),
                                          q_clean=q_clean.tolist(), q_noisy=q_noisy.tolist()))
        return kept["to_device"](array, device)

    def labels(clean, est_host, done=None, sample_rate=16000):
        q = kept["labels"](clean, est_host, done, sample_rate)
        record["est"].append(dict(clean_sum=float(clean.sum(dtype="float64")), q_est=q.tolist()))
        return q

    def weights(gram):
        w = kept["weights"](gram)
        record["sc"].append(w.tolist())
        return w

    def follow(*args, **kw):
        record["ref"] = kept["follow"](*args, **kw)
        return record["ref"]

    loop.gan_generator_step, loop._to_device, loop.estimate_labels = gen_step, to_device, labels
    gan._sc_weights_from_gram, ref_train.follow = weights, follow
    try:
        yield
    finally:
        loop.gan_generator_step, loop._to_device = kept["gen_step"], kept["to_device"]
        loop.estimate_labels, gan._sc_weights_from_gram = kept["labels"], kept["weights"]
        ref_train.follow = kept["follow"]


def parting(record: dict) -> dict:
    """Where the program and the reference part, step by step: each
    step's generator update (the gap of each leaf's norm against the
    larger of the reference leaf's and the median leaf's: median and
    worst; both sides' whole norms, all digits), the largest gap of each
    label, and both sides' self-correcting weights."""
    import numpy as np

    from sebench import training

    ref = record["ref"]
    prog = record["gen"]
    refp = [prog[0]] + ref["gen_step_params"]
    names = list(prog[0])
    steps = []
    for k in range(1, min(len(prog), len(refp))):
        dp = training.norms(prog[k][n] - prog[k - 1][n] for n in names)
        dr = training.norms(refp[k][n] - refp[k - 1][n] for n in names)
        gaps = training.leaf_gaps(dp, dr)
        i = int(gaps.argmax())
        steps.append(dict(update_median=float(np.median(gaps)),
                          update_worst=[names[i], float(gaps[i]), float(dp[i]), float(dr[i])],
                          update_norm_program=float(np.sqrt((dp ** 2).sum())),
                          update_norm_reference=float(np.sqrt((dr ** 2).sum()))))
    label_gaps = []
    for want in ref["labels"]:
        got = {k: v for b in record["batches"] if abs(b["clean_sum"] - want["clean_sum"]) < 1e-6
               for k, v in b.items()}
        got.update({k: v for e in record["est"] if abs(e["clean_sum"] - want["clean_sum"]) < 1e-6
                    for k, v in e.items()})
        label_gaps.append({k: (max(abs(a - b) for a, b in zip(got[k], want[k]))
                               if k in got else None)
                           for k in ("q_clean", "q_noisy", "q_est") if k in want})
    return dict(steps=steps, label_gaps=label_gaps, sc_program=record["sc"][:2],
                sc_reference=ref["sc_weights"],
                median_leaf_norm=statistics.median(
                    training.norms(prog[0][n] for n in names).tolist()))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--mode", default="program")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default=None)
    parser.add_argument("--diagnose", action="store_true")
    args = parser.parse_args(argv)

    from sebench import faults, harness

    overrides = {"params": {"precision": "bf16"}} if args.mode == "control" else None
    fault = faults.FAULTS[args.mode] if args.mode in faults.FAULTS else None
    if args.mode == "ieee":
        import torch

        torch.backends.cuda.matmul.fp32_precision = "ieee"
        torch.backends.cudnn.conv.fp32_precision = "ieee"
    Path("chiprun_out").mkdir(exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        record: dict = {}
        with contextlib.ExitStack() as stack:
            if fault:
                stack.enter_context(fault())
            if args.diagnose:
                stack.enter_context(diagnose(record))
            result = harness.run_cell(args.workload, seed, args.seconds, False, t0=t0,
                                      device=args.device, overrides=overrides)
        line = {"workload": args.workload, "mode": args.mode, "seed": seed,
                "correct": result["correct"], "failed": result["failed"],
                "checks": {k: v["value"] for k, v in result["checks"].items()},
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "readings": result.get("readings"),
                "parting": parting(record) if args.diagnose else None,
                "seconds": time.perf_counter() - t0, "kind": result["device"]["kind"]}
        print(json.dumps(line), flush=True)
        with open(os.path.join("chiprun_out", "calibrate.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
