"""Grouped expert GEMM and fused SwiGLU: ``moe_gemm.py`` holds the wrappers
and plain versions, ``csrc/`` the CUDA kernels."""
