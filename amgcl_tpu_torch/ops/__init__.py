"""Device formats, backend primitives and the hand-written kernels."""
