"""PyTorch/CUDA port of the sparse systolic tensor array reproduction.

The JAX package ``repro`` is the reference; this package re-implements its
INT8 sparse-CNN and LM serving paths, its trainer and its accounting for an
NVIDIA Hopper card. Every TPU kernel is a hand-written CUDA C++ kernel
(``repro_torch/kernels/csrc``),
built with ``nvcc`` at first use and bound with ``ctypes``. Each kernel's
plain PyTorch version sits beside it and is what runs for CPU tensors.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and never
``repro``. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Without a card a CUDA request raises instead of slipping
    onto the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
