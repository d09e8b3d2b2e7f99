"""Flash-decode GQA attention (dense and paged): ``decode_attention.py``
holds the wrappers and plain versions, ``csrc/`` the CUDA kernels."""
