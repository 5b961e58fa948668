"""Plain batched enhancement with the served semantics: utterances sorted
by length (stable), cut into batches of ``batch_size``, each batch
wrap-padded to its bucket (its longest utterance rounded up to a multiple
of ``quantum``, at least one quantum), RMS-normalized over the padded row,
featurized, enhanced, inverted, de-normalized and cut back to each
utterance's length.  Each row's result depends on its own samples and its
bucket only, so the reference computes each (utterance, bucket) pair once,
in blocks of rows of one bucket, in IEEE fp32."""

from __future__ import annotations

import numpy as np
import torch

from sebench.reference import dsp


def buckets(lengths: list[int], batch_size: int, quantum: int) -> list[int]:
    """The bucket each utterance is padded to."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    out = [0] * len(lengths)
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        longest = max(lengths[i] for i in chunk)
        bucket = max(quantum, -(-longest // quantum) * quantum)
        for i in chunk:
            out[i] = bucket
    return out


def wrap_pad(x: np.ndarray, target: int) -> np.ndarray:
    """``x`` repeated from its start up to ``target`` samples (or cut)."""
    return np.resize(np.asarray(x, np.float32), target)


@torch.no_grad()
def enhance_rows(model, rows: np.ndarray, n_fft: int, hop: int, power: float,
                 device) -> np.ndarray:
    noisy = torch.as_tensor(rows, device=device)
    gain = dsp.rms_gain(noisy)
    re, im = dsp.compressed_stft(noisy * gain, n_fft, hop, power)
    est_re, est_im = model(re, im)
    est = dsp.uncompressed_istft(est_re, est_im, n_fft, hop, power, noisy.shape[-1])
    return (est / gain).cpu().numpy()


def enhance_pairs(model, utterances: list[np.ndarray], pairs: set[tuple[int, int]], *,
                  n_fft: int, hop: int, power: float, device, block: int = 16
                  ) -> dict[tuple[int, int], np.ndarray]:
    """``{(utterance, bucket): enhanced utterance}`` for each pair."""
    out = {}
    for bucket in sorted({b for _, b in pairs}):
        ids = sorted(i for i, b in pairs if b == bucket)
        for start in range(0, len(ids), block):
            part = ids[start:start + block]
            est = enhance_rows(model, np.stack([wrap_pad(utterances[i], bucket) for i in part]),
                               n_fft, hop, power, device)
            for row, i in enumerate(part):
                out[(i, bucket)] = est[row, :len(utterances[i])]
    return out
