"""Hand-written Hopper kernels of the port (``csrc/*.cu``), each behind an
``ops.py`` wrapper with a plain PyTorch version in ``ref.py``. A wrapper
takes the plain version only for CPU tensors; on CUDA tensors it
launches its kernel or raises."""

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a caller needs the gradient of a kernel's result: a
    CUDA kernel fills its output through ``ctypes``, outside autograd, so
    the result would come back silently detached from its inputs."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            f"torch.no_grad() or on tensors that do not require grad "
            f"(train with attn_impl='plain')")
