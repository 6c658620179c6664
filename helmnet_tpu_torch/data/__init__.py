"""Datasets of sound-speed maps."""
