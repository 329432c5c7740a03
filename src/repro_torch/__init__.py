"""PyTorch/CUDA port of the matrix-free high-order elasticity solver.

The package mirrors :mod:`repro` module for module; each module's
reference is its namesake there.  It imports ``torch``, numpy and scipy
only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the fused PAop apply on the card is the hand-written
CUDA kernel in :mod:`repro_torch.kernels.pa_elasticity`, and the LM side's
attention (serving and training, its gradient included) the kernels in
:mod:`repro_torch.kernels.flash_attention`.
"""
