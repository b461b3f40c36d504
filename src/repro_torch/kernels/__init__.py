"""Hand-written Hopper kernels of the port (``csrc/*.cu``), each behind an
``ops.py`` wrapper with a plain PyTorch version in ``ref.py``. A wrapper
takes the plain version only for CPU tensors; on CUDA tensors it
launches its kernel or raises."""
