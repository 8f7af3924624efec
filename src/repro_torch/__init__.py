"""PyTorch/CUDA port of the FreqCa system (``repro`` stays the JAX
reference).

The port keeps ``repro``'s module layout and names so each piece has an
obvious counterpart.  It imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no CUDA device they raise instead of
dropping to the CPU (see :func:`repro_torch.device.resolve`).
"""
