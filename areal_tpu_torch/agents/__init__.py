"""Rollout agents (the math single-step agent)."""
