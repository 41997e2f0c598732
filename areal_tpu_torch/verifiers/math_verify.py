"""Timeout-hardened math verification.

The raw parser (areal_tpu/data/math_parser.py) calls sympy ``simplify``,
which can pathologically hang on adversarial generated answers.  The
reference isolates this behind a process pool
(reference: realhf/impl/dataset/math_parser.py ``parse_lines_in_parallel``'s
ProcessPoolExecutor + per-chunk timeouts).  This wrapper does the same with
recovery: items are verified in a process pool with a collective deadline;
on timeout the poisoned pool is discarded (hung workers and all) and the
unfinished items score 0.

The port's copy of ``areal_tpu/verifiers/math_verify.py``,
its imports renamed to ``areal_tpu_torch``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import multiprocessing
from typing import List, Optional

from areal_tpu_torch.base import logging_
from areal_tpu_torch.data.math_parser import verify_math_solution

logger = logging_.getLogger("math_verify")

#: minimum collective deadline; the effective deadline scales with batch
#: size so large reward batches are not spuriously zeroed
DEFAULT_TIMEOUT = 60.0
PER_ITEM_BUDGET = 5.0

_pool: Optional[concurrent.futures.ProcessPoolExecutor] = None


def _get_pool() -> concurrent.futures.ProcessPoolExecutor:
    global _pool
    if _pool is None:
        import os

        # spawn, not fork: the port's process holds threads and a CUDA
        # context, which a forked child would inherit half-held
        _pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=max(2, (os.cpu_count() or 8) // 4),
            mp_context=multiprocessing.get_context("spawn"),
        )
        atexit.register(_shutdown_pool)
    return _pool


def _shutdown_pool():
    global _pool
    if _pool is not None:
        # shutdown() alone never terminates RUNNING workers — a hung sympy
        # call would leak a CPU-burning process — so kill them explicitly
        procs = list(getattr(_pool, "_processes", {}).values())
        _pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            try:
                p.terminate()
            except (OSError, ValueError):
                pass
        _pool = None


def math_verify(
    generateds: List[str],
    solutions_list: List[List[str]],
    timeout: Optional[float] = None,
) -> List[float]:
    """Per-item 0/1 rewards; items unfinished by the deadline score 0.

    The default deadline scales with batch size over pool width (a 256-item
    PPO reward batch on 2 workers legitimately needs minutes; a fixed 60s
    would zero the healthy tail)."""
    assert len(generateds) == len(solutions_list)
    if not generateds:
        return []
    global _pool
    pool = _get_pool()
    if timeout is None:
        workers = pool._max_workers
        timeout = max(
            DEFAULT_TIMEOUT,
            PER_ITEM_BUDGET * len(generateds) / max(1, workers),
        )
    try:
        futures = [
            pool.submit(verify_math_solution, g, s)
            for g, s in zip(generateds, solutions_list)
        ]
    except (concurrent.futures.process.BrokenProcessPool, RuntimeError):
        _shutdown_pool()
        pool = _get_pool()
        futures = [
            pool.submit(verify_math_solution, g, s)
            for g, s in zip(generateds, solutions_list)
        ]
    done, not_done = concurrent.futures.wait(futures, timeout=timeout)
    rewards: List[float] = []
    for f in futures:
        if f in done and not f.exception():
            rewards.append(float(f.result()))
        else:
            rewards.append(0.0)
    if not_done:
        logger.warning(
            "math verify timed out on %d/%d items; recycling pool",
            len(not_done),
            len(futures),
        )
        _shutdown_pool()  # hung sympy workers poison the pool; start fresh
    return rewards
