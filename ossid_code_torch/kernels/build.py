"""Build and load the port's CUDA kernels (sources in `ossid_code_torch/csrc`).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into its own shared library, at first use, into `ossid_code_torch/_build/`
(listed in .gitignore). The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale one never loaded.
`build()` starts one `nvcc` per source, all at once, and waits for all of
them. Libraries are loaded with `ctypes`; every C entry point returns
`cudaGetLastError()` after its launch and `check()` raises on a non-zero code.

The host libraries that the loop needs (the PPF matcher and the depth
rasterizer) are the repository's C++ sources `native/<name>.cpp`, compiled by
`g++` the same way into the same directory at first use (`native_library`).
A missing compiler raises: there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the flags of native/Makefile
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-fopenmp", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _target(src: Path, flags: tuple = NVCC_FLAGS) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile the named sources (all when None) that are not built yet, one
    nvcc process per source, started together. Returns {name: compiler log}
    for the sources compiled by this call (ptxas register/shared-memory
    report included)."""
    srcs = sources() if names is None else [CSRC_DIR / f"{n}.cu" for n in names]
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for src in srcs:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    logs, failed = {}, []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed, with
    each entry point's ctypes signature, {name: (argtypes, restype)}, set
    once when it is loaded."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = _bind(_target(CSRC_DIR / f"{name}.cu"), signatures)
    return lib


def _bind(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def build_native(name: str) -> Path:
    """Compile `native/<name>.cpp` with g++ and native/Makefile's flags into
    `_build/` unless it is built already; returns the library's path."""
    src = NATIVE_DIR / f"{name}.cpp"
    out = _target(src, CXX_FLAGS)
    if not out.exists():
        cxx = shutil.which("g++")
        if not cxx:
            raise RuntimeError(f"no C++ compiler (g++) to build {src.name}")
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def native_library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded host library of `native/<name>.cpp` (`build_native`), with
    each entry point's ctypes signature set as in `library`."""
    key = f"native/{name}"
    lib = _loaded.get(key)
    if lib is None:
        lib = _loaded[key] = _bind(build_native(name), signatures)
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the pointer a kernel takes."""
    return torch.cuda.current_stream(device).cuda_stream
