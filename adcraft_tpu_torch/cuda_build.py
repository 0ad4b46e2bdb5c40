"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for sm_90a on first use into ``_build/`` (listed in
``.gitignore``) and cached there under a digest of the source, every
header it includes from ``csrc/`` (transitively) and the flags, so an
edited header never loads a stale library. Nothing is built at import:
the CPU never builds, and a CUDA tensor builds on its first launch.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# No -fmad=false: the day kernel spells each product and sum with
# __fmul_rn / __fadd_rn, so the math library keeps the default flags
# PyTorch's own kernels were built with (csrc/day_kernel.cu, "Numerics").
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(source: Path) -> List[Path]:
    """``source`` and every header it includes with quotes, transitively."""
    files, todo = [], [source]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for name in _INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return files


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/<name>.cu``, built and loaded on first ``get()``.

    ``bind`` declares the ctypes signatures of the library's launchers;
    ``flags`` are more nvcc flags (a second build of the same source, such
    as one with a diagnostic compiled in); ``csrc`` is the directory of the
    source and its headers (another tree's, to time two versions of a
    kernel side by side). The source also exports
    ``<name>_error_string(int)``, which ``check`` uses to turn a launcher's
    nonzero CUDA error into an exception.
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 flags: Tuple[str, ...] = (), csrc: Path = CSRC):
        self.source = Path(csrc).resolve() / f"{name}.cu"
        self.name = name
        self.flags = tuple(flags)
        self._bind = bind
        self._lib = None
        self.path = None
        self.build_seconds = None
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            t0 = time.perf_counter()
            self.path = self._build()
            lib = ctypes.CDLL(str(self.path))
            self._bind(lib)
            error_string = getattr(lib, f"{self.name}_error_string")
            error_string.argtypes = [ctypes.c_int]
            error_string.restype = ctypes.c_char_p
            self._lib = lib
            self.build_seconds = time.perf_counter() - t0
        return self._lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = getattr(self.get(), f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{what} launch failed: {msg} ({err})")

    def _build(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS + self.flags).encode())
        for path in source_files(self.source):
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
        out = BUILD_DIR / f"lib{self.name}_{digest.hexdigest()[:16]}.so"
        log = out.with_suffix(".log")  # nvcc's output, kept for ptxas' report
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return out
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename, so that concurrent first uses
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, *self.flags, "-o", tmp, str(self.source)],
                capture_output=True, text=True, check=False,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} "
                                   f"({proc.returncode}):\n{self.build_log}")
            log.write_text(self.build_log)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out


def build_all(libraries: Iterable[CudaLibrary]) -> None:
    """Build and load several libraries at once, one nvcc each."""
    libraries = list(libraries)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        for future in [pool.submit(lib.get) for lib in libraries]:
            future.result()
