"""The benchmark of the PyTorch/CUDA port: ``python3 benchmark/run.py``."""
