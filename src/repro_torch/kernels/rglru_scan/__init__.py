"""RG-LRU linear recurrence: ``rglru_scan.py`` holds the wrapper and the
plain version, ``csrc/`` the CUDA kernel."""
