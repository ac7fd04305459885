"""Hand-written Hopper (sm_90a) kernels, how they are built, and their wrappers."""
