"""Preemption-safe shutdown: catch SIGTERM/SIGINT, let the training loop
checkpoint and exit cleanly. A copy of ``disentangledcolorization_tpu/utils/signals.py``.

The reference has no preemption story at all — a killed run loses everything
since the last epoch-end ``model_last.pth.tar`` and recovery is a manual
``--resume`` (the reference trainer's epoch loop). On shared or spot
machines preemption is routine, so the trainers here wrap their epoch loops in :class:`GracefulShutdown`: the first
SIGTERM/SIGINT sets a flag the loop polls between steps, triggering one final
"last" checkpoint before a clean exit; a second signal escalates to an
immediate ``KeyboardInterrupt`` for stuck runs.
"""

from __future__ import annotations

import signal
import threading


class GracefulShutdown:
    """Context manager: flips :attr:`requested` on SIGTERM/SIGINT.

    Handlers are installed on ``__enter__`` and restored on ``__exit__``, so
    nesting inside a test harness or notebook leaves the process signal state
    untouched. Signal handlers must be installed from the main thread; from
    any other thread this degrades to a no-op flag (never requested).
    """

    def __init__(self, sigs=(signal.SIGTERM, signal.SIGINT)):
        self._sigs = tuple(sigs)
        self._prev: dict = {}
        self._requested = False
        self._active = False

    @property
    def requested(self) -> bool:
        return self._requested

    def _handler(self, signum, frame):
        if self._requested:
            # second signal: the loop isn't draining — escalate
            raise KeyboardInterrupt(f"second shutdown signal ({signum})")
        self._requested = True

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is threading.main_thread():
            for s in self._sigs:
                self._prev[s] = signal.signal(s, self._handler)
            self._active = True
        return self

    def __exit__(self, *exc) -> None:
        if self._active:
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self._active = False
        return None


def register_stack_dump(sig=signal.SIGUSR1) -> bool:
    """SIGUSR1 -> dump all thread stacks to stderr (faulthandler).

    When a long run wedges (a device wait or a loader thread that never
    returns), the only diagnostic is a thread dump. The trainers register it
    themselves so ``kill -USR1 <pid>`` is always safe and informative (a bare
    SIGUSR1 would otherwise terminate the process: default disposition).
    Main-thread only; returns False elsewhere.
    """
    import faulthandler

    if threading.current_thread() is not threading.main_thread():
        return False
    faulthandler.register(sig, all_threads=True, chain=False)
    return True
