"""repro_torch — the PyTorch/CUDA port of `repro` (KaHIP on one GPU).

The package mirrors `repro` module for module (``repro_torch/core/lp.py``
↔ ``repro/core/lp.py``) and imports neither jax nor `repro`.  Entry points
take ``device=None``, which means ``"cuda"``; without a card they raise
unless the caller passes ``device="cpu"``.  Kernel wrappers dispatch on the
tensor's device: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the hand-written kernel or raises.
"""
