"""Build the hand-written CUDA kernels and the host ops at first use and load
them with ctypes.

Each ``ops/csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library's file name carries a hash of every source in ``csrc/`` and of the
compiler flags, so an edited kernel is rebuilt and an unchanged one is reused.
All missing libraries are compiled together, one ``nvcc`` process each.

There is no fallback: a missing ``nvcc`` or a failed build raises. Wrappers
call :func:`load` only when they launch a kernel on a CUDA tensor; CPU
tensors take the plain PyTorch versions and never reach this module.

The host ops (``csrc/cpu_adam.cpp``, the optimizer-offload Adam, and
``csrc/aio.cpp``, the NVMe tier's async file I/O) are C++ for the CPU:
:func:`load_host` compiles each with the C++ compiler (``$CXX``, else
``c++`` or ``g++``; :func:`find_cxx`) and the JAX package's flags,
``-O3 -shared -fPIC -std=c++17 -fopenmp -march=native``, into
``build/host/``; a ``$CXX`` that cannot link OpenMP (no runtime next to
it) is passed over for ``c++`` or ``g++``. Their file names hash the
source, the flags, the compiler and the host CPU's model and flags
(``-march=native`` code runs only where it was built). They build on a
machine without ``nvcc``, so the CPU tests run them; a missing compiler or
a failed build raises here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes of the C entry points (csrc/common.cuh, DtypeCode)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# library (csrc/<library>.cu) -> {C entry point: argtypes}; every entry point
# returns its launch's cudaGetLastError()
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "decode_attention": {
        "dstorch_decode_attention": [_I, _I] + [_P] * 7 + [_I] * 7 + [_F,
                                                                       _P],
        "dstorch_decode_attention_int8": [_I, _I] + [_P] * 9 + [_I] * 7 + [
            _F, _P]},
    "flash_attention_fwd": {
        "dstorch_flash_attention_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, _I, _F, _I, _P],
        "dstorch_wgmma_pack_probe": [_I, _P, _P, _P, _P, _P]},
    "paged_decode_attention": {
        "dstorch_paged_decode_attention": [_I, _I] + [_P] * 8 + [_I] * 10 + [
            _F, _P],
        "dstorch_paged_decode_attention_int8": [_I, _I] + [_P] * 10 + [
            _I] * 10 + [_F, _P]},
    "int8_matmul": {
        "dstorch_int8_matmul": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                                _P]},
    "flash_attention_bwd": {
        "dstorch_flash_attention_dq": [_I, _I] + [_P] * 7 + [_I] * 6 + [
            _F, _I, _P],
        "dstorch_flash_attention_dkv": [_I, _I] + [_P] * 8 + [_I] * 6 + [
            _F, _I, _P]},
    "ln_linear": {
        "dstorch_ln_linear_fwd": [_I] + [_P] * 9 + [_I, _I, _I, _F, _P],
        "dstorch_ln_linear_bwd_dx": [_I] + [_P] * 10 + [_I, _I, _I, _P]},
    "block_sparse_attention": {
        "dstorch_block_sparse_fwd": [_I, _I] + [_P] * 7 + [_I] * 6 + [
            _F, _I, _P],
        "dstorch_block_sparse_dq": [_I, _I] + [_P] * 9 + [_I] * 6 + [_F, _I,
                                                                     _P],
        "dstorch_block_sparse_dkv": [_I, _I] + [_P] * 11 + [_I] * 6 + [
            _F, _I, _P]},
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

HOST_BUILD_DIR = BUILD_DIR.parent / "host"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
              "-march=native")
# host library (csrc/<library>.cpp) -> {C entry point: (argtypes, restype)}
_L = ctypes.c_int64
HOST_SIGNATURES = {
    "cpu_adam": {
        "ds_adam_step": ([_P] * 4 + [_L] + [_F] * 5 + [_I, _F, _F], None),
        "ds_adagrad_step": ([_P] * 3 + [_L, _F, _F, _F], None),
        "ds_f32_to_bf16": ([_P, _P, _L], None),
        "ds_has_nonfinite": ([_P, _L], _I)},
    "aio": {
        "ds_aio_create": ([_I, _L, _L, _I], _P),
        "ds_aio_destroy": ([_P], None),
        "ds_aio_pread": ([_P, ctypes.c_char_p, _P, _L, _L], _L),
        "ds_aio_pwrite": ([_P, ctypes.c_char_p, _P, _L, _L], _L),
        "ds_aio_wait": ([_P], _L),
        "ds_aio_wait_ticket": ([_P, _L], _L),
        "ds_aio_pending": ([_P], _L),
        "ds_aio_probe_o_direct": ([ctypes.c_char_p], _I)},
}
_HOST_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")


def sources_hash() -> str:
    """Hash of every kernel source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{sources_hash()}.so"


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(output), str(source)]


def build(names: Sequence[str] = tuple(SIGNATURES)) -> List[Path]:
    """Compile every library in ``names`` that is not built yet, all at
    once, and wait for them. Returns the library paths; raises
    :class:`KernelBuildError` with the compiler's output on failure."""
    targets = [(name, library_path(name)) for name in names]
    missing = [(name, out) for name, out in targets if not out.exists()]
    if missing:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in missing:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = nvcc_command(nvcc, CSRC / f"{name}.cu", tmp)
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu (exit {proc.returncode}):\n"
                                f"{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a file
        if failures:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return [out for _, out in targets]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built first if needed), with
    ``argtypes``/``restype`` set on its entry point."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            for symbol, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def launch(name: str, device: torch.device, *args,
           symbol: str = None) -> None:
    """Call library ``name``'s C entry point ``symbol`` (default
    ``dstorch_<name>``) on ``device`` and PyTorch's current stream there
    (appended as the last argument); raise if the launch reported an
    error."""
    symbol = symbol or f"dstorch_{name}"
    fn = getattr(load(name), symbol)
    with torch.cuda.device(device):  # the runtime launches on its device
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"{symbol}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# host ops


def _resolve(name: str):
    path = name if os.path.isabs(name) else shutil.which(name)
    return path if path and os.path.isfile(path) and \
        os.access(path, os.X_OK) else None


_OPENMP_PROBE = "#include <omp.h>\nextern \"C\" int probe() { " \
    "return omp_get_max_threads(); }\n"


@functools.lru_cache(maxsize=None)
def _builds_openmp(cxx: str) -> bool:
    """Whether ``cxx`` compiles and links OpenMP code with HOST_FLAGS (a
    compiler may lack its OpenMP runtime)."""
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HOST_BUILD_DIR) as tmp:
        src = Path(tmp) / "probe.cpp"
        src.write_text(_OPENMP_PROBE)
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(src) + ".so",
                               str(src)], stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    return proc.returncode == 0


def find_cxx() -> str:
    """The C++ compiler for the host ops: ``$CXX``, else ``c++``, else
    ``g++`` on ``PATH``, the first that builds OpenMP code with
    HOST_FLAGS (a ``$CXX`` without an OpenMP runtime is passed over).
    Raises when ``$CXX`` names no compiler, or when none can."""
    wanted = os.environ.get("CXX")
    if wanted and _resolve(wanted) is None:
        raise KernelBuildError(
            f"C++ compiler not found (CXX={wanted}); the host ops (cpu_adam, "
            f"aio) are built at first use")
    tried = []
    for name in ([wanted] if wanted else []) + ["c++", "g++"]:
        path = _resolve(name)
        if path is None or path in tried:
            continue
        tried.append(path)
        if _builds_openmp(path):
            return path
    raise KernelBuildError(
        f"no C++ compiler builds OpenMP code with {' '.join(HOST_FLAGS)} "
        f"(tried {tried or 'c++, g++: none on PATH'}); the host ops (cpu_adam,"
        f" aio) are built at first use")


def _cpu_signature() -> str:
    """The host CPU's model name and feature flags (``-march=native``)."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    lines.append(line.strip())
                if len(lines) >= 2:
                    break
    except OSError:
        pass
    return platform.machine() + "|" + "|".join(lines)


def host_library_path(name: str, cxx: str) -> Path:
    """``build/host/lib<name>-<hash>.so``: the hash covers the source, the
    flags, the compiler and the CPU."""
    h = hashlib.sha256(" ".join((cxx,) + HOST_FLAGS).encode())
    h.update(_cpu_signature().encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless it is built already and return the
    library's path. Raises :class:`KernelBuildError` when the compiler is
    missing or fails (there is no fallback). Concurrent builders each write a
    temporary file and rename it into place, so a reader never sees half a
    library."""
    cxx = find_cxx()
    out = host_library_path(name, cxx)
    if out.exists():
        return out
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"{cxx} failed on {name}.cpp (exit "
                               f"{proc.returncode}):\n"
                               f"{proc.stdout.decode(errors='replace')}")
    os.replace(tmp, out)
    return out


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``cpu_adam`` or ``aio``), built
    first if needed, with every entry point's argtypes and restype set."""
    with _LOCK:
        lib = _HOST_LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            for symbol, (argtypes, restype) in HOST_SIGNATURES[name].items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = restype
            _HOST_LIBS[name] = lib
        return lib
