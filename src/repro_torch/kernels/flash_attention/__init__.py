"""Flash attention over a whole sequence: ``flash_attention.py`` holds the
wrapper and the plain version, ``csrc/`` the CUDA kernel."""
