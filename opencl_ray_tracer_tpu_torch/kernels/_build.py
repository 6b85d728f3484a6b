"""Build and load the CUDA kernel libraries.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``_build/``
beside the package.  The library's file name carries a hash of the source,
of the headers in ``csrc/`` and of the flags, so an edit rebuilds it; the
compiler's report (registers, spills) is kept beside it as ``.log``.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str, defines: tuple = ()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` if it is not built yet, with each macro
    of ``defines`` defined (a variant); the library's path."""
    src = CSRC / f"{name}.cu"
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str, symbols: dict, defines: tuple = ()) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (with ``defines``, as ``build``),
    built if needed, with each function of ``symbols`` (name -> (argtypes,
    restype)) declared."""
    key = (name, *defines)
    if key not in _LIBS:
        lib = ctypes.CDLL(str(build(name, defines)))
        for fn_name, (argtypes, restype) in symbols.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[key] = lib
    return _LIBS[key]
