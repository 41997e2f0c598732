"""Environments (the math/code single-step environment)."""
