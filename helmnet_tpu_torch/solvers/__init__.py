"""The learned iterative solver."""
