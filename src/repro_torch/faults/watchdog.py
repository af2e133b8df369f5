"""Collective watchdog: heartbeat file and deadline thread, ported from
``repro/faults/watchdog.py``.

A fold that stops making progress (a peer lost mid-collective, a
kernel that never returns) strands the thread that waits on it, and
Python cannot interrupt a thread blocked in native code, so in-process
recovery is impossible by construction. What can be guaranteed is that
the hang becomes a typed, observable event: the watchdog thread watches
a deadline between ``beat()`` calls, keeps a JSON heartbeat file an
operator (or the chaos harness) can poll, and on expiry writes the
diagnosis (layer, cause, elapsed, restart instruction), then hands off
to the timeout handler. The default handler exits the process with
:data:`WATCHDOG_EXIT_CODE` (the supervisor's restart-from-checkpoint
signal); tests and the chaos harness install recording handlers and use
:meth:`CollectiveWatchdog.check` to turn a fired deadline into a
:class:`FaultDetected`.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Optional

from repro_torch.faults.plan import FaultDetected, count

# Exit status of a watchdog-killed process: distinct from crash (!=1)
# and from SIGKILL (negative in waitpid terms), so a supervisor can
# tell "stranded in a collective, restart me from the checkpoint"
# apart from every other death.
WATCHDOG_EXIT_CODE = 17

_DEFAULT_ACTION = ("the process is stranded in a collective — kill it "
                   "and restart from the last checkpoint generation")


def exit_handler(info: dict) -> None:
    """Default timeout handler: print the typed diagnosis and exit
    with :data:`WATCHDOG_EXIT_CODE`. ``os._exit`` on purpose — the
    stranded collective would block any orderly interpreter teardown."""
    print(f"FaultDetected[{info['layer']}]: {info['cause']} exceeded "
          f"its {info['deadline_s']}s deadline — {info['action']}",
          file=sys.stderr, flush=True)
    os._exit(WATCHDOG_EXIT_CODE)


class CollectiveWatchdog:
    """Deadline thread + heartbeat file around a blocking section.

    Usage::

        with CollectiveWatchdog(30, heartbeat_path=hb,
                                cause="wave 7 merge") as wd:
            for t in rounds:
                run_round()      # may strand forever on peer loss
                wd.beat()        # resets the deadline, stamps the file
        wd.check()               # record-mode: raise if it fired
    """

    def __init__(self, deadline_s: float,
                 heartbeat_path: Optional[str] = None,
                 layer: str = "transport",
                 cause: str = "collective",
                 action: Optional[str] = None,
                 on_timeout: Optional[Callable[[dict], None]] = None,
                 poll_s: Optional[float] = None):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.heartbeat_path = heartbeat_path
        self.layer, self.cause = layer, cause
        self.action = action or _DEFAULT_ACTION
        self._on_timeout = on_timeout if on_timeout is not None \
            else exit_handler
        self._poll_s = poll_s if poll_s is not None \
            else max(min(deadline_s / 4.0, 0.5), 0.01)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last = 0.0
        self._beats = 0
        self._fired = False
        self._info: Optional[dict] = None

    # -- heartbeat file (atomic, self-contained: no ckpt import) -----------

    def _write(self, status: str, **extra) -> None:
        if self.heartbeat_path is None:
            return
        payload = {"status": status, "layer": self.layer,
                   "cause": self.cause, "beats": self._beats,
                   "deadline_s": self.deadline_s, "ts": time.time(),
                   **extra}
        tmp = self.heartbeat_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.heartbeat_path)
        except OSError:
            pass                       # a failing heartbeat disk must
            #                            never take the workload down

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "CollectiveWatchdog":
        self._last = time.monotonic()
        self._stop.clear()
        self._write("alive")
        self._thread = threading.Thread(
            target=self._loop, name="collective-watchdog", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self._poll_s * 4, 1.0))
            self._thread = None

    def beat(self) -> None:
        """Progress proof: resets the deadline, stamps the heartbeat."""
        self._last = time.monotonic()
        self._beats += 1
        self._write("alive")

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            elapsed = time.monotonic() - self._last
            if elapsed <= self.deadline_s:
                continue
            self._fired = True
            count("watchdog_fires")
            self._info = {"layer": self.layer, "cause": self.cause,
                          "deadline_s": self.deadline_s,
                          "elapsed_s": round(elapsed, 3),
                          "action": self.action}
            self._write("timeout", **self._info)
            self._on_timeout(self._info)
            return

    # -- record-mode surface -----------------------------------------------

    @property
    def fired(self) -> bool:
        return self._fired

    @property
    def info(self) -> Optional[dict]:
        return self._info

    def check(self) -> None:
        """Raise the typed timeout if the deadline fired (for handlers
        that record instead of exiting)."""
        if self._fired:
            raise FaultDetected(
                self.layer,
                f"{self.cause} exceeded its {self.deadline_s}s "
                "watchdog deadline", self.action)
