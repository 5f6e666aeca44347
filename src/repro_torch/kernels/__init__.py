"""Hand-written Hopper kernels, their build helper and plain oracles."""
