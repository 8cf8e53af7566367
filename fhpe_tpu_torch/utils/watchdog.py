"""Stall watchdog: turn a run that hangs on the card into a restart.

A copy of ``fhpe_tpu/utils/watchdog.py`` (pure stdlib; the class pinned to
it by source equality in ``tests/test_torch_watchdog.py`` wherever the
text is the same, which is all of it but the stall message).

On the card a training process can block forever in a device wait and
make no progress, with no exception and no exit: a peer rank that died
leaves its all-reduce, captured into the step's CUDA graph, waiting in a
replay; a fault of the CUDA stack or a kernel that never ends blocks the
host at the next window read (``utils/logger.py::WindowedMeters.drain``)
or at the epoch's ``torch.cuda.synchronize``.  ``StallWatchdog`` closes that gap.
The train and eval loops call ``beat()`` every time they complete an
iteration; a daemon thread checks the time since the last beat.  If it
exceeds ``timeout_s`` the watchdog

1. logs the stall and dumps every thread's stack (``faulthandler``) so
   the blocking frame is visible post-mortem,
2. runs any registered ``on_stall`` callbacks (the CLIs flush the pending
   checkpoint write) on a daemon helper with a hard time budget, so that
   a callback that itself blocks cannot stop the exit,
3. force-exits with ``exit_code`` 86 (``os._exit``: a thread blocked in a
   device wait never returns to let a clean ``sys.exit`` through).

The blocked call must release the GIL for the monitor thread to run:
``float()`` of a CUDA tensor does (``chip_smoke.py`` phase 33 finds a
stalled run's main thread in ``WindowedMeters.drain`` and the watchdog
fires).  A supervisor restarts the CLI (a shell loop on exit 86, or
``torchrun --max-restarts N``, which restarts every worker when one exits
non-zero) and ``AUTO_RESUME`` restores the last rolling checkpoint, with
``FHPE_RUN_TAG`` pinning the run directory across restarts.

Enabled via ``TPU.STALL_TIMEOUT_S`` (default 0 = off).  The timeout is
armed only once the FIRST beat arrives; ``disarm()`` suspends it until
the next beat.  The CLIs disarm it across the dataset metric (host only)
and across every call of a compiled step that captures its CUDA graph
(``utils/graph.py::before_capture``: that call runs the step eagerly, may
build the kernels with ``nvcc`` and records the graph, and must not count
against a step's budget).
"""

from __future__ import annotations

import faulthandler
import os
import threading
import time

__all__ = ["StallWatchdog", "null_watchdog"]

DEFAULT_EXIT_CODE = 86  # distinct from shell/timeout codes; supervisors
                        # can treat it as "stalled: restart me"


class StallWatchdog:
    """Daemon-thread liveness monitor for a device-bound loop.

    Parameters
    ----------
    timeout_s: stall threshold.  <= 0 disables (every method is a no-op),
        so call sites can construct one unconditionally.
    logger: stdlib logger for the stall report (optional).
    on_stall: iterable of zero-arg callables run before exiting; errors
        are swallowed (the process is about to die anyway).
    exit_fn: test seam; defaults to ``os._exit``.
    poll_s: check interval of the monitor thread.
    """

    def __init__(self, timeout_s: float, logger=None, on_stall=(),
                 exit_code: int = DEFAULT_EXIT_CODE, exit_fn=None,
                 poll_s: float | None = None,
                 callback_timeout_s: float = 30.0):
        self.timeout_s = float(timeout_s)
        self.enabled = self.timeout_s > 0
        self.logger = logger
        self.on_stall = tuple(on_stall)
        self.exit_code = exit_code
        self.callback_timeout_s = float(callback_timeout_s)
        self.exit_fn = exit_fn if exit_fn is not None else os._exit
        self.poll_s = poll_s if poll_s else min(max(self.timeout_s / 4, 0.05), 30.0)
        self._last_beat = None  # armed by the first beat()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.fired = False
        if self.enabled:
            self._thread = threading.Thread(
                target=self._run, name="fhpe-stall-watchdog", daemon=True)
            self._thread.start()

    # -- loop-side API ----------------------------------------------------
    def beat(self):
        """Record forward progress (cheap; called once per iteration)."""
        if self.enabled:
            with self._lock:
                self._last_beat = time.monotonic()

    def disarm(self):
        """Suspend monitoring until the next beat (e.g. across a known
        long device-free section such as a dataset evaluation)."""
        if self.enabled:
            with self._lock:
                self._last_beat = None

    def stop(self):
        """Shut the monitor down (end of run)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- monitor thread ---------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                last = self._last_beat
            if last is None:  # not armed yet (compiling / disarmed)
                continue
            idle = time.monotonic() - last
            if idle >= self.timeout_s:
                self._fire(idle)
                return

    def _fire(self, idle: float):
        self.fired = True
        msg = (f"STALL WATCHDOG: no progress for {idle:.0f}s "
               f"(timeout {self.timeout_s:.0f}s) — the card or a peer "
               f"rank presumed hung; dumping thread stacks and exiting "
               f"{self.exit_code} for supervised restart (AUTO_RESUME "
               f"restores the last checkpoint)")
        if self.logger is not None:
            try:
                self.logger.error(msg)
                for h in self.logger.handlers:
                    try:
                        h.flush()
                    except Exception:
                        pass
            except Exception:
                pass
        try:
            faulthandler.dump_traceback(all_threads=True)
        except Exception:
            pass
        # Callbacks run on a daemon helper with a hard time budget: a
        # callback that itself blocks on the dead transport/storage (e.g.
        # flush_pending joining a wedged checkpoint write) must not stop
        # the force-exit — guaranteeing the exit is this class's one job.
        def run_callbacks():
            for cb in self.on_stall:
                try:
                    cb()
                except Exception:
                    pass
        t = threading.Thread(target=run_callbacks, daemon=True,
                             name="fhpe-stall-callbacks")
        t.start()
        t.join(timeout=self.callback_timeout_s)
        self.exit_fn(self.exit_code)


def null_watchdog() -> StallWatchdog:
    """A disabled watchdog (all methods no-ops) for default call sites."""
    return StallWatchdog(0.0)
