"""Build the CUDA C++ kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The output lands in ``build/kernels/`` at the root of the checkout, keyed
by a hash of the source and the flags, so an edited kernel is rebuilt and
an unchanged one is loaded as it is.  ``build(names)`` (``build_all()``:
every source) starts one ``nvcc`` per source at once and waits for all of
them; ``library(name)`` builds on first use.  Each C entry returns
``cudaGetLastError()``; `check` raises when it is not 0.

The kernels are forward only, as the JAX package's are (it defines no VJP
for any of them), and a launch through ctypes leaves no autograd graph:
every public wrapper calls `refuse_grad` first, so a forward that would
train through a kernel raises instead of returning an output with no
gradient path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source with the "
            "CUDA toolkit on the machine with the card")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none
    return log


def build(names) -> dict[str, str]:
    """Compile each named source that is not built yet, one nvcc per
    source, all started together.  Returns each source's ptxas report
    (empty when the library was already built)."""
    with _lock:
        jobs = {name: _start(name) for name in names}
        return {name: _finish(name, job) for name, job in jobs.items()}


def build_all() -> dict[str, str]:
    """`build` every source."""
    return build(sources())


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def entry(name: str, symbol: str, n_ptrs: int, n_ints: int,
          scale: bool = True):
    """The C entry ``symbol`` of ``csrc/<name>.cu``, typed as the kernels'
    entries are: ``n_ptrs`` pointers, ``n_ints`` ints, the softmax scale
    (float; attention kernels only, ``scale=False`` for the others) and the
    stream, returning the CUDA error code."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * scale + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def call(fn, device, *args):
    """Call the C entry ``fn`` with ``args`` and the raw handle of the
    current stream of CUDA ``device``, on that device: the short launch
    path (no stream object is built, and the current device is switched
    only when it is another)."""
    cur = torch.cuda.current_device()
    idx = cur if device.index is None else device.index
    if idx == cur:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def refuse_grad(what: str, *tensors):
    """Raise before a kernel wrapper dispatches when autograd would need its
    gradient: grad mode on and any tensor input requiring grad.  Host flags
    only (no sync, no launch), on every device: the plain version a CPU
    tensor runs is differentiable, but the card's kernel is not, and the
    two must refuse alike."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what}: the kernel is forward only and the JAX package defines "
            "no VJP for it; train on the plain path (the config's *_impl "
            "left at its default) or run the kernel under torch.no_grad()")


def check_operands(what: str, device, operands):
    """Raise unless every ``(name, tensor, dtype)`` is a contiguous tensor
    of that dtype on ``device``: the kernels take raw pointers."""
    for name, t, dt in operands:
        if t.dtype != dt or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"tensor on {device}")


def check(name: str, err: int, what: str):
    """Raise if a C entry of ``csrc/<name>.cu`` reported a CUDA error
    (every source exports ``cuda_error_string`` to name it)."""
    if err != 0:
        msg = library(name).cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
