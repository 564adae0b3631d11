"""Build and load the port's hand-written kernels at first use.

Each source under ``csrc/`` compiles into a shared library with a plain C
interface, loaded with ``ctypes``; pointers and the CUDA stream are passed
as Python ints. Libraries land in ``stylerenderer_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that hashes the sources and the flags, so a
changed source rebuilds and an unchanged one loads the library already there.

- ``nvcc`` libraries (``multi``: ``csrc/rasterize_multi.cu``, K1 and its
  binning passes; ``single``: ``csrc/rasterize_single.cu``, K2 and its
  binning passes) for Hopper
  (``sm_90a``), built in parallel by ``build_cuda_libraries()``.
  ``--fmad=false`` keeps every ``a*b+c`` as a rounded multiply and a
  rounded add, as the oracle computes them; the default ``-prec-div=true``
  keeps IEEE division; fast math is never on. ``-Xptxas -v`` reports registers and shared memory
  (``build_log()``).
- ``g++`` libraries (``multi_host``, ``single_host``) of the same per-candidate
  math for the CPU tests, ``-ffp-contract=off`` for the same reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}
_SECONDS: dict[str, float] = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build(name: str, compiler: list[str], flags: tuple[str, ...],
           source: str, headers: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``source`` into ``_build/<name>-<hash>.so`` unless that file
    exists, and load it (uncached: ``library`` caches it once its argument
    types are set)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (source,) + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    log = ""
    t0 = time.perf_counter()
    if not os.path.exists(out):
        # compile to a private name, then rename: a concurrent build never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = compiler + list(flags) + ["-I", CSRC, "-o", tmp,
                                        os.path.join(CSRC, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {source} failed:\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    _SECONDS[name] = time.perf_counter() - t0
    _LOGS[name] = log
    return ctypes.CDLL(out)


def build_log(name: str) -> str:
    """The compiler's output of the build this process ran ('' if loaded)."""
    return _LOGS.get(name, "")


def build_seconds(name: str) -> float:
    return _SECONDS.get(name, 0.0)


_MULTI_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float]
_BIN_ARGS = [ctypes.c_void_p] * 3  # v, tri, attrs; then the outputs and scratch
_BIN_SHAPE = [ctypes.c_int] * 8 + [ctypes.c_float]
# rows, starts, wins; B, nf, h, w, tile, perspective; eps
_SINGLE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
# rows, starts, wins; B, nf, h, w, tile, round, perspective; eps
_SINGLE_HOST_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float]
# B, nv, nf, h, w, tile, perspective; eps
_BIN_SINGLE_SHAPE = [ctypes.c_int] * 7 + [ctypes.c_float]
_STREAM = [ctypes.c_void_p]
_MULTI_HEADERS = ("rasterize_multi.cuh", "bin_multi.cuh", "bin_passes.cuh")
_SINGLE_HEADERS = ("rasterize_single.cuh", "bin_single.cuh", "rasterize_multi.cuh",
                   "bin_multi.cuh", "bin_passes.cuh")

# name -> (compiler, source, headers, {C function: argument types})
_SPECS = {
    "multi": ("nvcc", "rasterize_multi.cu", _MULTI_HEADERS,
              {"sr_rasterize_multi": _MULTI_ARGS + _STREAM,
               "sr_bin_multi": _BIN_ARGS + [ctypes.c_void_p] * 6 + _BIN_SHAPE + _STREAM,
               "sr_rasterize_multi_shape": [ctypes.c_int] * 4 + [ctypes.c_void_p]}),
    "single": ("nvcc", "rasterize_single.cu", _SINGLE_HEADERS,
               {"sr_rasterize_single": _SINGLE_ARGS + _STREAM,
                "sr_bin_single": [ctypes.c_void_p] * 7 + _BIN_SINGLE_SHAPE + _STREAM,
                "sr_rasterize_single_shape": [ctypes.c_int, ctypes.c_void_p]}),
    "multi_host": ("g++", "rasterize_multi_host.cpp", _MULTI_HEADERS,
                   {"sr_rasterize_multi_host": _MULTI_ARGS + [ctypes.c_int] * 2,
                    "sr_bin_multi_host": _BIN_ARGS + [ctypes.c_void_p] * 4 + _BIN_SHAPE}),
    "single_host": ("g++", "rasterize_single_host.cpp", _SINGLE_HEADERS,
                    {"sr_rasterize_single_host": _SINGLE_HOST_ARGS,
                     "sr_bin_single_host": [ctypes.c_void_p] * 5 + _BIN_SINGLE_SHAPE}),
}
CUDA_LIBRARIES = tuple(n for n, spec in _SPECS.items() if spec[0] == "nvcc")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    return gxx


def library(name: str) -> ctypes.CDLL:
    """Build (unless built) and load the library ``name`` of ``_SPECS``."""
    if name not in _LIBS:
        compiler, source, headers, functions = _SPECS[name]
        if compiler == "nvcc":
            lib = _build(name, [_find_nvcc()], NVCC_FLAGS, source, headers)
            lib.sr_error_string.argtypes = [ctypes.c_int]
            lib.sr_error_string.restype = ctypes.c_char_p
        else:
            lib = _build(name, [_gxx()], GXX_FLAGS, source, headers)
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        # cached only now: a caller never sees ctypes' default conversions
        _LIBS[name] = lib
    return _LIBS[name]


def build_cuda_libraries() -> None:
    """Build every Hopper library at once, one ``nvcc`` per source, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(CUDA_LIBRARIES)) as pool:
        list(pool.map(library, CUDA_LIBRARIES))
