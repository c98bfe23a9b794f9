"""The benchmark of the PyTorch and CUDA port, sos_wsod_torch (see run.py)."""
