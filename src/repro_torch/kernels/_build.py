"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point, loaded with ``ctypes`` at first use and
cached by a hash of the source and the flags under ``build/repro_torch/``
at the root of the checkout.  Nothing is built or loaded when a module is
imported.  ``build_all`` starts one ``nvcc`` per kernel, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
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

    def build(self) -> pathlib.Path:
        """Compile the library if no build of this source exists yet."""
        src = self.source.read_bytes()
        digest = hashlib.sha256(
            src + " ".join(self.flags).encode()).hexdigest()
        out = BUILD_DIR / f"{self.name}-{digest[:16]}.so"
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
