"""One ``nvcc`` build for each of the port's CUDA libraries.

Each library is one ``.cu`` source under ``csrc/`` compiled for sm_90a
into ``build/<name>`` at the repository root, a shared library with a
plain C interface that its wrapper loads through ctypes. A library is
rebuilt when it is missing or older than its source or one of the headers
under ``csrc/`` that it includes (``#include "..."``, followed through
nested includes), so a change to one source rebuilds that library alone. A
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
# --fmad=false: products and sums round one by one, as the plain torch
# versions compute them, so kernel and plain version agree bit for bit
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def local_headers(source: str) -> list[str]:
    """The files under ``csrc/`` that ``csrc/<source>`` includes with
    ``#include "..."``, directly or through one of them."""
    found, todo = [], [source]
    while todo:
        with open(os.path.join(CSRC, todo.pop())) as f:
            for name in _INCLUDE.findall(f.read()):
                if name not in found and os.path.exists(os.path.join(CSRC, name)):
                    found.append(name)
                    todo.append(name)
    return found


def build(source: str, lib_name: str) -> tuple[str, str]:
    """Compiles ``csrc/<source>`` into ``build/<lib_name>`` unless the
    library is newer than the source and every header it includes
    (:func:`local_headers`). Returns ``(library path, nvcc output)``; the
    output (``-Xptxas -v``'s register and spill report) is empty when the
    library was up to date."""
    src = os.path.join(CSRC, source)
    so = os.path.join(BUILD_DIR, lib_name)
    newest = max(os.path.getmtime(os.path.join(CSRC, n))
                 for n in (source, *local_headers(source)))
    if os.path.exists(so) and os.path.getmtime(so) >= newest:
        return so, ""
    compiler = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler] + NVCC_FLAGS + ["-o", tmp, src]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log[-6000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, log
