"""PyTorch/CUDA port of the reproduction (counterpart of ``src/repro``).

Same module layout as the JAX package, so each module has one reference
twin; parity tests in ``tests/test_torch_*.py`` hold the two against each
other. This package imports ``torch``, numpy and the stdlib only — never
``jax`` and nothing under ``repro.*``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve_device``).
"""
