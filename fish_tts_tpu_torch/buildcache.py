"""Build directory for the port's native libraries.

Native code (the BPE encoder, the CUDA kernels) is compiled at first use
into ``build/`` at the root of the checkout, which ``.gitignore`` lists.
Each library's file name carries a hash of its sources, so an edit to a
source builds a new library and a stale one is never loaded.  Builds go to
a temporary file that is renamed into place, so processes that build at
the same time converge on one file.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Callable, Iterable


def build_root() -> Path:
    return Path(__file__).resolve().parent.parent / "build"


def source_hash(paths: Iterable[Path]) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_once(target: Path, build: Callable[[Path], None]) -> Path:
    """Return ``target``, first calling ``build(tmp_path)`` to make it if it
    does not exist yet.  ``build`` raises on failure."""
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=target.suffix, dir=target.parent)
    os.close(fd)
    try:
        build(Path(tmp))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target
