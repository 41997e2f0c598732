"""Compile sentinel: count, attribute, and alarm on kernel-library loads
(port of ``areal_tpu/observability/compile_watch.py``).

The JAX package counts XLA compiles of its jitted serving entries.  The
port's eager entries compile nothing per shape: what "compiles" is the
first use of a kernel library, its ``nvcc`` build (or the load of a build
found on disk, ``ops/_build.py`` ``build`` / ``load_library``).  So the
watch keeps the JAX package's class, counters, metric names
(``areal_xla_*``) and sentinel, over two signals:

* **entry polling** (the per-fn signal): each watched entry exposes
  ``_cache_size()``, the number of the kernel libraries it launches that
  this process has loaded (:func:`library_entry`); a poll that finds it
  grown counts the new loads under ``areal_xla_compiles_total{fn=}`` and
  records an ``xla.compile`` trace span carrying the caller's shape
  signature.
* **library loads** (the process-wide timing signal): every load feeds
  its build's nvcc seconds (0 for a build found on disk) into the
  ``areal_xla_compile_seconds`` histogram and a ``fn="backend"`` counter
  row, through one listener in ``ops/_build.py`` that dispatches to every
  live watch (a WeakSet: a dropped watch unenrolls itself).

**Steady-state guard**: after ``GenServerConfig.compile_quiet_after_steps``
engine steps the watch is marked steady; any load on a watched entry from
then on fires ``areal_trace_stall_total{kind="recompile"}`` ONCE PER
EPISODE (a burst of loads is one alarm; a quiet poll re-arms) and invokes
the ``on_steady_compile`` callback so the worker can force-sample the
trace roots the load stalled.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional

from areal_tpu_torch.observability.registry import get_registry
from areal_tpu_torch.observability.table import stall_kind
from areal_tpu_torch.observability.tracing import get_tracer

#: live CompileWatch instances the library-load listener dispatches to
_active_watches: "weakref.WeakSet[CompileWatch]" = weakref.WeakSet()
_listener_lock = threading.Lock()
_listener_installed = False


def _on_library_load(name: str, secs: float) -> None:
    for watch in list(_active_watches):
        watch._note_backend_compile(float(secs))


def _install_load_listener() -> None:
    """Register the process-wide load listener once."""
    global _listener_installed
    with _listener_lock:
        if not _listener_installed:
            from areal_tpu_torch.ops import _build

            _build.add_load_listener(_on_library_load)
            _listener_installed = True


class library_entry:  # noqa: N801 - a watched entry, used like a function
    """A watched entry over the kernel libraries an entry point launches:
    ``_cache_size()`` is how many of them this process has loaded, the
    port's counterpart of a jitted function's compiled-cache size."""

    def __init__(self, *libraries: str):
        self.libraries = tuple(libraries)

    def _cache_size(self) -> int:
        from areal_tpu_torch.ops import _build

        return _build.loaded_count(*self.libraries)


class CompileWatch:
    """Per-worker compile counter + steady-state recompile sentinel.

    ``quiet_after_steps``: engine steps before the steady-state guard
    arms (0 disables the sentinel; counting always runs).
    ``on_steady_compile(fns)``: called once per episode with the entry
    points that loaded a library, so the owner can force-sample the
    stalled trace roots.  ``monitoring`` enrolls the watch in the
    process-wide library-load signal."""

    def __init__(
        self,
        registry=None,
        tracer=None,
        quiet_after_steps: int = 0,
        on_steady_compile: Optional[Callable[[List[str]], None]] = None,
        monitoring: bool = True,
    ):
        self._registry = registry if registry is not None else get_registry()
        self._tracer = tracer if tracer is not None else get_tracer()
        self.quiet_after_steps = max(0, int(quiet_after_steps))
        self._on_steady_compile = on_steady_compile
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}
        self._steady = False
        self._episode_fired = False
        # cumulative plain counters (mirrored onto the metrics RPC)
        self.compiles_total: Dict[str, int] = {}
        self.steady_compiles_total = 0
        self.sentinel_fires_total = 0
        self.monitoring_active = bool(monitoring)
        if self.monitoring_active:
            _install_load_listener()
            _active_watches.add(self)

    # -- registration -------------------------------------------------------

    @staticmethod
    def _cache_size(fn) -> Optional[int]:
        try:
            return int(fn._cache_size())
        except Exception:
            return None

    def watch(
        self,
        fn_name: str,
        entry,
        signature: Optional[Callable[[], str]] = None,
    ) -> bool:
        """Track an entry point by its ``_cache_size()``.  ``signature()``
        (optional) renders the current shape/dtype signature for the
        ``xla.compile`` span attrs.  Returns False when the entry exposes
        no cache size (nothing to poll)."""
        size = self._cache_size(entry)
        if size is None:
            return False
        with self._lock:
            self._entries[fn_name] = {
                "fn": entry,
                "last": size,
                "signature": signature,
            }
            self.compiles_total.setdefault(fn_name, 0)
        return True

    def cache_sizes(self) -> Dict[str, int]:
        """Each watched entry's size at its last poll (its libraries
        loaded)."""
        with self._lock:
            return {k: int(e["last"]) for k, e in self._entries.items()}

    # -- state --------------------------------------------------------------

    def note_step(self, step: int) -> None:
        """Arm the steady-state guard once the engine step counter
        clears ``quiet_after_steps`` (0 = never arms)."""
        if (
            not self._steady
            and self.quiet_after_steps > 0
            and int(step) >= self.quiet_after_steps
        ):
            self._steady = True

    def set_steady(self, steady: bool) -> None:
        self._steady = bool(steady)
        if not steady:
            self._episode_fired = False

    @property
    def steady(self) -> bool:
        return self._steady

    @property
    def armed(self) -> bool:
        """True when the next steady-state compile will fire the
        sentinel (steady and not mid-episode)."""
        return self._steady and not self._episode_fired

    # -- signals ------------------------------------------------------------

    def _note_backend_compile(self, secs: float) -> None:
        """A library load anywhere in the process (no per-fn attribution:
        the polled entries carry that)."""
        self._registry.counter("areal_xla_compiles_total").inc(
            fn="backend"
        )
        self._registry.histogram("areal_xla_compile_seconds").observe(
            secs
        )

    def poll(self) -> Dict[str, int]:
        """Diff every watched entry's size; count, trace, and (when
        steady) run the sentinel.  Returns the new loads by fn for this
        poll (empty = quiet)."""
        fresh: Dict[str, int] = {}
        with self._lock:
            for fn_name, ent in self._entries.items():
                cur = self._cache_size(ent["fn"])
                if cur is None:
                    continue
                n = cur - ent["last"]
                ent["last"] = cur
                if n > 0:
                    fresh[fn_name] = n
                    self.compiles_total[fn_name] = (
                        self.compiles_total.get(fn_name, 0) + n
                    )
        counter = self._registry.counter("areal_xla_compiles_total")
        for fn_name, n in fresh.items():
            counter.inc(float(n), fn=fn_name)
            ent = self._entries.get(fn_name) or {}
            sig_fn = ent.get("signature")
            sig = ""
            if sig_fn is not None:
                try:
                    sig = str(sig_fn())
                except Exception:
                    sig = "?"
            root = f"xla-{fn_name}"
            # loads are rare and fleet-relevant: always record them
            self._tracer.force(root)
            self._tracer.span_begin(
                root, "xla.compile", root=root,
                fn=fn_name, new_entries=n, signature=sig,
            )
            self._tracer.span_end(root, "xla.compile", root=root)
        if self._steady:
            if fresh:
                self.steady_compiles_total += sum(fresh.values())
                if not self._episode_fired:
                    self._episode_fired = True
                    self.sentinel_fires_total += 1
                    self._registry.counter("areal_trace_stall_total").inc(
                        kind=stall_kind("recompile")
                    )
                    if self._on_steady_compile is not None:
                        try:
                            self._on_steady_compile(sorted(fresh))
                        except Exception:
                            pass
            else:
                # a clean poll ends the episode: the next steady-state
                # load is a NEW alarm
                self._episode_fired = False
        return fresh

    def stats(self) -> Dict[str, float]:
        """Plain cumulative counters for the metrics RPC."""
        out: Dict[str, float] = {
            f"xla_compiles/{fn}": float(n)
            for fn, n in sorted(self.compiles_total.items())
        }
        out["xla_steady_compiles_total"] = float(self.steady_compiles_total)
        out["xla_sentinel_fires_total"] = float(self.sentinel_fires_total)
        return out

    def close(self) -> None:
        _active_watches.discard(self)
        self.monitoring_active = False
