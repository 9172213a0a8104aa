"""Build the CUDA C++ kernels with ``nvcc`` and bind them with ``ctypes``.

Each source in ``csrc/`` exports plain C entry points, so it compiles in
seconds without PyTorch's headers. ``build_all`` starts one ``nvcc`` per
source, all together, on the first launch of any kernel; each library is
named by a hash of its sources and flags and lands in the repository's
``build/kernels`` directory (``REPRO_TORCH_BUILD_DIR`` overrides it), so a
change to a source rebuilds it. Nothing here runs at import.

A :class:`CudaKernel` is one entry point. Its wrapper in the kernel module
checks the operands and calls :meth:`CudaKernel.launch`, which raises on a
nonzero ``cudaGetLastError`` and counts the launch, under the operand
variant the wrapper names (the tc matmul's bf16 instantiation counts as
``vdbb_matmul_tc_bf16``). A variant may have an entry point of its own in
the same source (the tc matmul's wgmma core, ``vdbb_matmul_tc_wgmma``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("im2col_conv.cu", "vdbb_conv_tc.cu", "vdbb_matmul_tc.cu", "vdbb_conv_bw.cu",
           "vdbb_matmul_bw.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

P = ctypes.c_void_p
I = ctypes.c_int

KERNELS: dict = {}  # name -> CudaKernel, filled as the kernel modules import


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir() / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all(sources=SOURCES) -> dict:
    """Build every source whose library is missing, one ``nvcc`` per source,
    all started together. Returns {source: library path}. The compiler's
    output (``-Xptxas=-v``: registers, shared memory, spills) is kept in a
    ``.log`` beside each library."""
    paths = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = {}
    for src, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


class CudaKernel:
    """One ``extern "C"`` entry point of a source in ``csrc/``: it returns the
    ``cudaError_t`` of its launch. ``counts`` holds its successful launches
    per operand variant: ``""`` counts under the entry's own name, each of
    ``variants`` (e.g. ``"bf16"``) and of ``entries`` under
    ``<name>_<variant>``. ``entries`` maps a variant to an entry point of
    its own in the same source, ``(symbol, argtypes)``; the other variants
    launch through ``name``."""

    def __init__(self, name: str, source: str, argtypes, *, replaces: str, variants=(),
                 entries=None):
        self.name, self.source, self.replaces = name, source, replaces
        self.argtypes = list(argtypes)
        self.entries = {"": (name, self.argtypes), **(entries or {})}
        self.counts = dict.fromkeys(("",) + tuple(variants) + tuple(entries or ()), 0)
        self._lib = None
        self._fns = {}
        KERNELS[name] = self

    def _entry(self, variant: str = ""):
        symbol, argtypes = self.entries.get(variant, self.entries[""])
        if symbol not in self._fns:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(build_all()[self.source]))
            fn = getattr(self._lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def counted_name(self, variant: str = "") -> str:
        return f"{self.name}_{variant}" if variant else self.name

    def launch(self, *args, variant: str = "") -> None:
        err = self._entry(variant)(*args)
        if err != 0:
            raise RuntimeError(f"{self.counted_name(variant)}: CUDA error {err} at launch")
        self.counts[variant] += 1


def reset_launches() -> None:
    for k in KERNELS.values():
        k.counts = dict.fromkeys(k.counts, 0)


def launch_counts() -> dict:
    """{counted name: launches}, one entry per kernel and operand variant."""
    return {k.counted_name(v): n for k in KERNELS.values() for v, n in k.counts.items()}


def kernel_of(counted: str) -> CudaKernel:
    """The entry point a :func:`launch_counts` name counts launches of."""
    for k in KERNELS.values():
        if any(k.counted_name(v) == counted for v in k.counts):
            return k
    raise KeyError(counted)


# --- helpers the wrappers share -------------------------------------------

_IN_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.int8: 2, torch.bfloat16: 3}


def pointer(t):
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(name: str, *tensors, dtype, bf16: bool = False) -> int:
    """Validate what the kernel takes: CUDA, one device, contiguous, int8 or
    fp32 operands of ``dtype`` (int8 positions pass with their own dtype),
    or bf16 where the kernel has that instantiation (``bf16``). Returns the
    operand kind code."""
    kinds = (torch.int8, torch.float32) + ((torch.bfloat16,) if bf16 else ())
    if dtype not in kinds:
        raise TypeError(f"{name}: operands must be one of {kinds}, got {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on {dev} (CUDA); got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return _IN_KIND[dtype]


def out_kind(dtype) -> int:
    return _OUT_KIND[dtype]
