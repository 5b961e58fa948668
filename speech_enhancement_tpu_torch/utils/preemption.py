"""Preemption handling (the port's copy of
speech_enhancement_tpu/utils/preemption.py): SIGTERM and SIGINT request a
graceful stop; the training loop saves a checkpoint and returns, and
``--resume auto`` picks the run back up."""

from __future__ import annotations

import signal


class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers; ``should_stop`` flips once."""

    def __init__(self, install: bool = True):
        self.should_stop = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # not on the main thread

    def _handler(self, signum, frame):
        self.should_stop = True

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
