"""Entry points: the in-process local runner and the async-PPO CLI."""
