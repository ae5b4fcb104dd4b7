"""PyTorch/CUDA port of the `repro` JAX package (Binarized Neural Networks).

The package mirrors `repro`'s layout (`core/`, `kernels/`, `models/`,
`configs/`) and keeps its public layouts (NHWC images, (K, N) dense weights,
HWIO conv kernels), so every function here has a counterpart with the same
name there. It imports torch and numpy only, never jax and nothing of
`repro`.

Entry points that create tensors take `device=`; left out, it means the CUDA
card, and they raise when there is none. Functions that take tensors run
where their inputs lie: the kernel wrappers launch the hand-written Hopper
kernels on CUDA tensors and run their plain PyTorch versions on CPU tensors.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
