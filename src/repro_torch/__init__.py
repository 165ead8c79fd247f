"""PyTorch/CUDA port of the paper's multi-stage retrieval cascade.

The JAX package ``repro`` is the reference this package is held to; the
port imports nothing of it (nor JAX) and mirrors its layout, so each
module's counterpart has the same path under ``repro``.  Entry points run
on the card (``device=None`` resolves to ``cuda`` and raises when no CUDA
device is present); the tests pass ``device="cpu"``, where each kernel
wrapper runs its plain PyTorch version.  The hand-written CUDA kernels live
under ``repro_torch.kernels``.
"""
