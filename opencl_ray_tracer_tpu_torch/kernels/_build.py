"""Build and load the CUDA kernel libraries, and the host C++ library of
``io/native.py``.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``_build/``
beside the package.  The library's file name carries a hash of the source,
of the headers in ``csrc/`` and of the flags, so an edit rebuilds it; the
compiler's report (registers, spills) is kept beside it as ``.log``.
``build_host`` compiles a C++ source with the host compiler (``$CXX``, by
default ``g++``) the same way.  Nothing is built when a module is
imported.  A build writes a temporary file and renames it into place, so
processes that build the same library at once each load a whole one.
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
# the flags of the JAX package's native/Makefile
HOST_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
_LIBS: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _compiled(compiler: str, src: pathlib.Path, flags: list,
              headers=()) -> pathlib.Path:
    """``src`` compiled by ``compiler`` with ``flags`` into ``_build/``,
    unless a library of the same source, ``headers`` and flags is there
    already; the library's path.  A failed build raises with the
    compiler's errors."""
    digest = hashlib.sha256(src.read_bytes())
    for header in headers:
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    lib = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(compiler)} failed on "
                           f"{src}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build(name: str, defines: tuple = ()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` if it is not built yet, with each macro
    of ``defines`` defined (a variant); the library's path."""
    return _compiled(_nvcc(), CSRC / f"{name}.cu",
                     [*NVCC_FLAGS, *(f"-D{d}" for d in defines)],
                     sorted(CSRC.glob("*.cuh")))


def build_host(src: pathlib.Path) -> pathlib.Path:
    """Compile the C++ source ``src`` into a shared library with the host
    compiler (``$CXX``, else ``g++``) and ``HOST_FLAGS``, if it is not
    built yet; the library's path.  Raises when there is no compiler or
    the build fails."""
    compiler = shutil.which(os.environ.get("CXX") or "g++")
    if compiler is None:
        raise RuntimeError("no C++ compiler found: install g++ or set CXX")
    return _compiled(compiler, pathlib.Path(src), HOST_FLAGS)


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
