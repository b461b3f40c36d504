"""AttMemo on PyTorch + CUDA (Hopper): the port of the JAX package ``repro``.

Same module layout as ``repro`` (configs, data, models, optim, core,
memo, kernels), PyTorch idiom inside. Entry points take an explicit
``device`` and run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise (``device.resolve_device``).
"""
