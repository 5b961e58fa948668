"""Faults planted under the timed path, for the tests and the readings
that show a check catches them (``calibrate.py``, ``tests/``).  Each is a
context manager that patches the program while it is active."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, make):
    """``obj.name`` replaced by ``make(obj.name)`` inside; the attribute as
    it was (a static method stays one) restored on exit."""
    stored = vars(obj)[name]
    setattr(obj, name, make(getattr(obj, name)))
    try:
        yield
    finally:
        setattr(obj, name, stored)


def answer_altered():
    """Serving: each batch's first row scaled by 1.1 where the batch is
    collected."""
    from speech_enhancement_tpu_torch.enhance import Enhancer

    def make(collect):
        def altered(pending):
            out = collect(pending).copy()
            out[0] *= 1.1
            return out
        return staticmethod(altered)
    return _patched(Enhancer, "_collect", make)


def serving_half_batch():
    """Serving: the second half of each batch's rows left out (returned as
    the first half's)."""
    from speech_enhancement_tpu_torch.enhance import Enhancer

    def make(collect):
        def half(pending):
            out = collect(pending).copy()
            keep = max(1, out.shape[0] // 2)
            out[keep:] = out[:keep][: out.shape[0] - keep, :]
            return out
        return staticmethod(half)
    return _patched(Enhancer, "_collect", make)


def state_unchanged():
    """Training: the optimizers' step returns the state unchanged."""
    from speech_enhancement_tpu_torch.train import optim

    return _patched(optim.Optimizer, "step", lambda step: lambda self: None)


def training_half_batch():
    """Training: each generator step takes the first half of the batch's
    rows only, its losses the mean over them; what it hands on (the
    estimate, the magnitudes) is the half's, repeated to the batch's rows."""
    import torch

    from speech_enhancement_tpu_torch.train import loop

    def make(step):
        def half(state, clean, noisy, seed, **kw):
            rows = clean.shape[0]
            keep = max(1, rows // 2)
            aux = step(state, clean[:keep], noisy[:keep], seed, **kw)

            def pad(t):
                return torch.cat([t, t[:rows - keep]])
            return aux._replace(**{f: pad(getattr(aux, f)) for f in (
                "est_audio", "clean_audio", "noisy_audio", "est_mag", "clean_mag", "noisy_mag")})
        return half
    return _patched(loop, "gan_generator_step", make)


FAULTS = {"answer_altered": answer_altered, "serving_half_batch": serving_half_batch,
          "state_unchanged": state_unchanged, "training_half_batch": training_half_batch}
