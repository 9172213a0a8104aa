"""The run's environment, set before torch is imported."""
from __future__ import annotations

import os


def pin_caches(root: str) -> None:
    """Every cache of the program and its libraries at a fixed path inside
    the checkout; JAX kept out of libraries that would load it."""
    build = os.path.join(root, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(build, "portbench", "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
