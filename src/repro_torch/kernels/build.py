"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds).  Builds happen at first
use, are keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, and land in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``;
``REPRO_TORCH_BUILD_DIR`` overrides it).  :func:`build_all` starts one
``nvcc`` per source at once.

Nothing here runs at import time: the CPU tests import every module of the
port on machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("paged_copy", "flash_attention", "paged_attention",
           "paged_prefill_attention", "wkv6", "wkv6_chunked", "paged_gather",
           "matmul", "ragged_dot")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of every launcher: (source, function name, argtypes).
#: Pointers and the stream are ``c_void_p``; each returns its
#: ``cudaError_t`` as an int.  One source may hold several launchers.
SIGNATURES = {
    "paged_copy": ("paged_copy", "paged_copy_launch",
                   [_P] * 7 + [_I] * 6 + [_LL] * 6 + [_I, _P]),
    "flash_attention": ("flash_attention", "flash_attention_launch",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                         _P, _I, _P]),
    "paged_attention": ("paged_attention", "paged_decode_attention_launch",
                        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _LL, _I, _F, _F, _I, _I, _I, _I, _I, _I, _P]),
    "paged_prefill_attention": (
        "paged_prefill_attention", "paged_prefill_attention_launch",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _LL,
         _F, _F, _I, _I, _I, _I, _P]),
    "wkv6": ("wkv6", "wkv6_launch", [_P] * 8 + [_I, _I, _I, _P]),
    "wkv6_config": ("wkv6", "wkv6_config", [_I, _P]),
    "wkv6_chunked": ("wkv6_chunked", "wkv6_chunked_launch",
                     [_P] * 8 + [_I, _I, _I, _P]),
    "wkv6_chunked_config": ("wkv6_chunked", "wkv6_chunked_config",
                            [_I, _P]),
    "paged_gather": ("paged_gather", "paged_gather_launch",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
                      _I, _P]),
    "matmul": ("matmul", "matmul_launch",
               [_P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _I, _I, _I, _I, _I,
                _P]),
    "ragged_dot": ("ragged_dot", "ragged_dot_launch",
                   [_P] * 4 + [_I] * 4 + [_LL] * 4 + [_I, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
build_logs: dict[str, str] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build" / "kernels"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on the machine "
            "with the card (CUDA toolkit under /usr/local/cuda)")
    return path


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{key}.so"


def _start(name: str):
    """Spawn nvcc for ``name`` into a temporary file next to its target."""
    target = _target(name)
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc, tmp: str, target: pathlib.Path) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)          # atomic: concurrent builds agree
    build_logs[name] = out


def build_all(names=SOURCES) -> None:
    """Compile every missing library, one nvcc per source, all at once."""
    with _lock:
        pending = [(n, *_start(n)) for n in names if not _target(n).exists()]
        errors = []
        for name, proc, tmp, target in pending:
            try:
                _finish(name, proc, tmp, target)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library of source ``name`` (compiled on first use)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for source, fn_name, argtypes in SIGNATURES.values():
                if source == name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _loaded[name] = lib
    return lib


def launcher(name: str):
    """The C launch function ``name`` of :data:`SIGNATURES`, with its
    argtypes set."""
    source, fn_name, _ = SIGNATURES[name]
    return getattr(load(source), fn_name)


def check(err: int, name: str) -> None:
    """Raise when a launch returned a non-zero ``cudaError_t``, or a
    negative code from encoding a TMA tensor map (``csrc/hopper.cuh``)."""
    if err == -1:
        raise RuntimeError(f"{name}: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if err < 0:
        raise RuntimeError(f"{name}: TMA tensor map encode failed with "
                           f"CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
