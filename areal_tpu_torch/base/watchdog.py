"""Bounded execution of one named section in a daemon thread (port of
``areal_tpu/base/watchdog.py``).

``run_bounded`` runs ``fn`` in a daemon thread, joins it for
``timeout_s`` and reports ``{status: ok|error|timeout, seconds[,
result|error]}``, so one hung or failing section forfeits its own result
instead of the whole run's time budget.  Best effort by design: a thread
that hangs holding a lock others need can time out the sections behind
it too, but each of them is bounded the same way.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Dict


def run_bounded(
    fn, *args, name: str = "section", timeout_s: float = 300.0, **kw
) -> Dict[str, Any]:
    """Run ``fn(*args, **kw)`` in a daemon thread joined for
    ``timeout_s`` seconds.  Returns ``{"status": "ok", "seconds": s,
    "result": r}``, ``{"status": "error", "seconds": s, "error": msg}``
    (exception repr, truncated), or ``{"status": "timeout",
    "seconds": s}`` when the thread is still alive at the deadline."""
    t0 = time.perf_counter()
    box: Dict[str, Any] = {}

    def target():
        try:
            box["result"] = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - the outcome IS the data
            traceback.print_exc()
            box["error"] = f"{type(e).__name__}: {e}"[:300]

    th = threading.Thread(target=target, daemon=True, name=name)
    th.start()
    th.join(timeout_s)
    out: Dict[str, Any] = {
        "seconds": round(time.perf_counter() - t0, 1)
    }
    if th.is_alive():
        out["status"] = "timeout"
    elif "error" in box:
        out["status"] = "error"
        out["error"] = box["error"]
    else:
        out["status"] = "ok"
        out["result"] = box.get("result")
    return out
