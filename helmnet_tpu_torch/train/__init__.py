"""Weights from training runs: the reference checkpoint import."""
