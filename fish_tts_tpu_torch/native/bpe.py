"""ctypes binding for the native BPE encoder (``bpe.cc``).

The library is compiled with ``g++`` at first use into the port's build
directory (see ``buildcache``).  It is the port's only encoder: the machine
that runs the port has no ``tiktoken``, so a failed build raises instead of
falling back.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import sys
from pathlib import Path

from fish_tts_tpu_torch.buildcache import build_once, build_root, source_hash

_SRC_DIR = Path(__file__).parent
_SOURCES = ("bpe.cc", "unicode_tables.h")
_ABI_VERSION = 1


def build_library() -> Path:
    """Compile bpe.cc into the build directory (idempotent); returns the .so."""
    srcs = [_SRC_DIR / n for n in _SOURCES]
    target = build_root() / "native" / f"libfishbpe-{source_hash(srcs)}.so"

    def build(out: Path) -> None:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
               str(_SRC_DIR / "bpe.cc"), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native BPE build failed:\n{proc.stderr[-2000:]}")

    return build_once(target, build)


class NativeBPE:
    """Encode ordinary text (no special tokens) with the native library."""

    def __init__(self, lib: ctypes.CDLL, ranks: dict[bytes, int]):
        self._lib = lib
        blob = bytearray()
        for tok, rank in ranks.items():
            blob += struct.pack("<I", len(tok)) + tok + struct.pack("<I", rank)
        blob = bytes(blob)
        self._handle = lib.ft_bpe_new(blob, len(blob))
        if not self._handle:
            raise RuntimeError("ft_bpe_new rejected the vocab blob")

    def encode_ordinary(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        out = ctypes.POINTER(ctypes.c_uint32)()
        n = self._lib.ft_bpe_encode(self._handle, data, len(data), ctypes.byref(out))
        if n < 0:
            raise ValueError("native BPE encode failed")
        try:
            return out[:n]
        finally:
            self._lib.ft_ids_free(out)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ft_bpe_free(handle)
            self._handle = None


_LIB: ctypes.CDLL | None = None


def _load_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    if sys.byteorder != "little":
        raise RuntimeError("the native BPE vocab blob is little-endian only")
    lib = ctypes.CDLL(str(build_library()))
    lib.ft_abi_version.restype = ctypes.c_int
    lib.ft_abi_version.argtypes = []
    if lib.ft_abi_version() != _ABI_VERSION:
        raise RuntimeError("native BPE library ABI mismatch")
    lib.ft_bpe_new.restype = ctypes.c_void_p
    lib.ft_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ft_bpe_free.restype = None
    lib.ft_bpe_free.argtypes = [ctypes.c_void_p]
    lib.ft_bpe_encode.restype = ctypes.c_int64
    lib.ft_bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
    ]
    lib.ft_ids_free.restype = None
    lib.ft_ids_free.argtypes = [ctypes.POINTER(ctypes.c_uint32)]
    _LIB = lib
    return lib


def load_native_bpe(ranks: dict[bytes, int]) -> NativeBPE:
    """Build/load the library and wrap ``ranks``; raises if unavailable."""
    return NativeBPE(_load_lib(), ranks)
