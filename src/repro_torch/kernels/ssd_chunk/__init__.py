"""Mamba-2 SSD chunked scan: ``ssd_chunk.py`` holds the wrapper and the
plain version, ``csrc/`` the CUDA kernel."""
