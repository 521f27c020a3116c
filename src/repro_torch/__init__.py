"""PyTorch + CUDA port of the correlation-sketch join-correlation engine.

Mirrors the module layout of the JAX package (``core``, ``data``,
``engine``, ``kernels``) so each module has an obvious counterpart. The
port imports ``torch`` and numpy only. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``, where every kernel dispatch goes
to its plain PyTorch twin (`repro_torch.kernels.ref`).
"""
