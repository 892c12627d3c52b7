"""Hand-written Hopper kernels and their wrappers (built on first launch)."""
