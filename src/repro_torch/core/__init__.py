"""AttMemo core on PyTorch. Light on purpose: import the submodules you
need (``repro_torch.core.engine`` pulls in the whole serving stack)."""
