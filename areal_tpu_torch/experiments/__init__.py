"""Experiment builders (PPO math and async PPO)."""
