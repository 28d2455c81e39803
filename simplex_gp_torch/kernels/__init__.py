"""Hand-written Hopper kernels: the build from csrc/ and the wrappers beside their plain versions."""
