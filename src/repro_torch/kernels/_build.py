"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, loaded with ``ctypes`` at first use and
cached under ``build/repro_torch/`` at the root of the checkout by a hash
of the source, of every header it includes by quoted path (recursively)
and of the flags.  Nothing is built or loaded when a module is
imported.  ``build_all`` starts one ``nvcc`` per kernel, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: pathlib.Path) -> list:
    """``source`` and every file it includes by quoted path, recursively,
    each resolved beside the file that includes it (as ``nvcc`` does)."""
    found, todo = [], [pathlib.Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        for name in _QUOTED_INCLUDE.findall(path.read_text()):
            included = (path.parent / name).resolve()
            if included.exists():
                todo.append(included)
    return found


def source_digest(source: pathlib.Path, flags) -> str:
    """Hash of ``source``, the headers it includes and the flags."""
    source = pathlib.Path(source).resolve()
    h = hashlib.sha256()
    for path in sorted(source_files(source)):
        h.update(os.path.relpath(path, source.parent).encode() + b"\0")
        h.update(path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("the port's CUDA kernels need nvcc to build")


class CudaKernel:
    """One ``csrc/<name>.cu`` source, its ``nvcc`` flags and its binding.

    ``bind(lib)`` sets ``argtypes``/``restype`` on the loaded library's
    entry points.  ``build_seconds`` is the wall time of this process's
    ``nvcc`` run (None when a cached build was found) and ``build_log``
    its output (the ptxas register and spill report).
    """

    def __init__(self, name: str, flags: tuple, bind):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.flags = BASE_FLAGS + tuple(flags)
        self._bind = bind
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> pathlib.Path:
        """Where the build of the current sources and flags goes."""
        digest = source_digest(self.source, self.flags)
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    def build(self) -> pathlib.Path:
        """Compile the library if no build of these sources exists yet."""
        out = self.library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *self.flags, "-Xptxas=-v", "-o", str(tmp),
               str(self.source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({res.returncode}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
        self.build_seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        return out

    def lib(self):
        """The loaded library (built on first use)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


def build_all(kernels) -> None:
    """Build every kernel at once, one ``nvcc`` process each."""
    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        for future in [pool.submit(k.build) for k in kernels]:
            future.result()
