"""Multi-task reward dispatch: route each generated answer to its verifier
(port of ``areal_tpu/verifiers/dispatch.py``).

Math answers (``math``/``stem``) go to the hardened final-answer checker
(``verifiers/math_verify.py``).  Code answers need the sandboxed testcase
runner, and the HTTP verifier service (``AREAL_VERIFIER_URL``) is the
reference's remote mode: neither is ported (ROADMAP.md queue 1, item 15),
and both raise ``NotImplementedError`` rather than score an answer 0.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

from areal_tpu_torch.base import logging_

logger = logging_.getLogger("verifier_dispatch")


def verify_batch(
    tasks: Sequence[str],
    texts: Sequence[str],
    problems: Sequence[Dict],
    timeout: float = 300.0,
) -> List[float]:
    """Score ``texts[i]`` (the generated answer for ``problems[i]``, a
    dataset info dict) under the verifier selected by ``tasks[i]``.

    Task tags: ``math`` / ``stem`` -> final-answer equivalence;
    ``code`` -> sandboxed testcase execution."""
    assert len(tasks) == len(texts) == len(problems)
    if os.environ.get("AREAL_VERIFIER_URL"):
        raise NotImplementedError(
            "the HTTP verifier service (AREAL_VERIFIER_URL) is not ported to "
            "areal_tpu_torch yet (ROADMAP.md queue 1, item 15)"
        )
    return verify_batch_local(tasks, texts, problems)


def verify_batch_local(
    tasks: Sequence[str],
    texts: Sequence[str],
    problems: Sequence[Dict],
) -> List[float]:
    rewards = [0.0] * len(texts)

    math_idx = [i for i, t in enumerate(tasks) if t in ("math", "stem")]
    if math_idx:
        from areal_tpu_torch.verifiers.math_verify import math_verify

        math_rewards = math_verify(
            [texts[i] for i in math_idx],
            [problems[i].get("solutions", []) for i in math_idx],
        )
        for i, r in zip(math_idx, math_rewards):
            rewards[i] = r

    if any(t == "code" for t in tasks):
        raise NotImplementedError(
            "code verification (task 'code': the sandboxed testcase runner) "
            "is not ported to areal_tpu_torch yet (ROADMAP.md queue 1, item "
            "15)"
        )

    unknown = set(tasks) - {"math", "stem", "code"}
    if unknown:
        logger.warning("unknown task tags scored 0: %s", sorted(unknown))
    return rewards
