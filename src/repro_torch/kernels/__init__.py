"""Hand-written Hopper (sm_90a) kernels of the port."""
