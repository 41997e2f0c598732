"""Reward verifiers: the task dispatch and the hardened math checker
(code verification is not ported: ROADMAP.md queue 1, item 15)."""
