"""Physics operators and the hand-written kernels."""
