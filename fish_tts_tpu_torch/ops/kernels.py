"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each ``.cu`` is compiled by its own ``nvcc`` process for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``.  The library
lands in the build directory under a hash of the sources (``buildcache``)
and is built at first use, never at import: the CPU-only test machine has
no ``nvcc`` and only ever calls the plain PyTorch versions.

Every C entry takes an array of pointers, an array of ints, (sometimes) a
float, and the CUDA stream, and returns a ``cudaError_t``; ``launch``
raises on a non-zero return.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from fish_tts_tpu_torch.buildcache import build_once, build_root, source_hash

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_UNITS = ("sampler.cu", "slow_stack.cu", "fast_decoder.cu")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    return build_root() / "kernels" / f"libfts_kernels-{source_hash(_sources())}.so"


def build() -> Path:
    """Compile the kernels (idempotent); returns the shared library."""
    nvcc = _nvcc()

    def compile_and_link(out: Path) -> None:
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            procs, objs = [], []
            for unit in _UNITS:
                obj = Path(tmp) / (unit + ".o")
                objs.append(str(obj))
                cmd = [nvcc, _ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-c", str(CSRC / unit), "-o", str(obj)]
                procs.append((unit, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failed = []
            for unit, proc in procs:
                log, _ = proc.communicate(timeout=900)
                (Path(tmp).parent / (unit + ".log")).write_text(log)
                if proc.returncode != 0:
                    failed.append(f"{unit}:\n{log[-4000:]}")
            if failed:
                raise RuntimeError("nvcc failed\n" + "\n".join(failed))
            link = subprocess.run([nvcc, _ARCH, "-shared", "-o", str(out), *objs],
                                  capture_output=True, text=True, timeout=300)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")

    return build_once(library_path(), compile_and_link)


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        so = ctypes.CDLL(str(build()))
        vp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        so.fts_sample_slow.argtypes = [vp, ip, ctypes.c_void_p]
        so.fts_slow_stack_step.argtypes = [vp, ip, ctypes.c_float, ctypes.c_void_p]
        so.fts_fast_decode_frame.argtypes = [vp, ip, ctypes.c_float, ctypes.c_void_p]
        for fn in (so.fts_sample_slow, so.fts_slow_stack_step, so.fts_fast_decode_frame):
            fn.restype = ctypes.c_int
        so.fts_error_string.argtypes = [ctypes.c_int]
        so.fts_error_string.restype = ctypes.c_char_p
        _LIB = so
    return _LIB


def launch(name: str, tensors: list[torch.Tensor | None], dims: list[int],
           eps: float | None = None) -> None:
    """Call C entry ``name`` with the tensors' data pointers (None for a null
    pointer) on the current stream; raises on a CUDA error.  The caller
    keeps the tensors alive."""
    fn = _FNS.get(name) or _FNS.setdefault(name, getattr(lib(), name))
    ptrs = (ctypes.c_void_p * len(tensors))(*[0 if t is None else t.data_ptr() for t in tensors])
    ints = (ctypes.c_int * len(dims))(*dims)
    stream = _raw_stream(tensors[0].device.index)
    err = fn(ptrs, ints, stream) if eps is None else fn(ptrs, ints, ctypes.c_float(eps), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib().fts_error_string(err).decode()}")


_FNS: dict[str, ctypes._CFuncPtr] = {}


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer handle;
    PyTorch's raw accessor skips building a Stream object on every call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple[int, ...] | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``)."""
    if (t.dtype == dtype and t.is_cuda and (shape is None or t.shape == shape)
            and t.is_contiguous()):
        return
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


@functools.cache
def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


MAX_HEAD_DIM = 128  # csrc/common.cuh kMaxHeadDim
MAX_GROUP = 8       # csrc/common.cuh kMaxGroup: query heads per KV head


def block_dims_error(dim: int, n_head: int, n_kv: int, head_dim: int,
                     inter: int) -> str | None:
    """Why the transformer widths do not fit the GEMV and attention kernels
    (16-byte weight rows and the head limits of ``common.cuh``), or None."""
    if any(n % 16 for n in (dim, n_head * head_dim, inter)):
        return ("dim, n_head * head_dim and intermediate size must be multiples of 16 "
                "(the GEMV loads 16 int8 weights at a time)")
    if head_dim % 2 or head_dim > MAX_HEAD_DIM or n_head % n_kv or n_head // n_kv > MAX_GROUP:
        return (f"head_dim {head_dim} (even, <= {MAX_HEAD_DIM}) or {n_head}/{n_kv} heads "
                f"(<= {MAX_GROUP} per KV head) not supported")
    return None


def check_block_dims(name: str, dim: int, n_head: int, n_kv: int, head_dim: int,
                     inter: int) -> None:
    """Raise where :func:`block_dims_error` finds a fault."""
    err = block_dims_error(dim, n_head, n_kv, head_dim, inter)
    if err is not None:
        raise ValueError(f"{name}: {err}")
