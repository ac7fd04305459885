"""The benchmark of the PyTorch and CUDA port: ``python benchmark/run.py``."""
