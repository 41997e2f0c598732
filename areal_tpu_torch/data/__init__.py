"""Datasets (the math/code prompt dataset) and the math answer parser."""
