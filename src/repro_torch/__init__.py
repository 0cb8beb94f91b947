"""PyTorch/CUDA port of the banked-memory reproduction (``repro``).

The package mirrors ``src/repro`` module for module and imports nothing of
it, nor JAX.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the hand-written CUDA kernels live in ``csrc/`` and are
built at first use (see ``repro_torch.kernels.cuda_lib``).
"""
