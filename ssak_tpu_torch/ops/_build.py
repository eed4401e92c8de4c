"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by its own `nvcc` into
`build/ssak_tpu_torch/lib<name>-<digest>.so` at the repo root (`build/` is
git-ignored); all missing libraries are compiled in parallel. The digest
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused. The sources expose plain C functions (no PyTorch
headers), so a build takes seconds.

Host C++ sources (the n-gram scorer, decode/native/ngram.cpp; the audio
codecs and the duration scan, audio/native/*.cpp) are built the same way by
`g++` (`host_library`): one library per source, so a missing system
library loses only the source that links it, into `build/ssak_tpu_torch/`,
keyed on the source, the flags and the link flags. A failed build raises.

Nothing here runs at import: the CPU tests import every module, and a host
without the CUDA toolkit has no nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "ssak_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs = {}
build_log = {}  # name -> (seconds, ptxas report), filled by build_all (seconds 0 for a library built before)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def sources() -> list:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all() -> dict:
    """Compile every csrc/*.cu whose library is missing, one nvcc process
    per source, all started together; each ptxas report is kept beside its
    library and read back into build_log when the library was there.
    Returns {name: library path}."""
    paths = {name: _lib_path(name) for name in sources()}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    for name in paths.keys() - todo.keys():
        if os.path.exists(paths[name] + ".ptxas"):
            with open(paths[name] + ".ptxas") as f:
                build_log[name] = (0.0, f.read())
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        with open(todo[name] + ".ptxas", "w") as f:
            f.write(out)
        os.replace(tmp, todo[name])
        build_log[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build_all()[name])
        return _libs[name]


def host_library(source: str, libs=()) -> ctypes.CDLL:
    """The loaded library of the host C++ file `source`, compiled by
    `g++ -O3 -shared -fPIC -std=c++17 SOURCE LIBS` (link flags such as
    ("-ldl",)) into BUILD_DIR on first use, under a name keyed on the digest
    of the source, the flags and `libs`, so an edited source rebuilds.
    Raises RuntimeError when g++ is missing or fails."""
    with _lock:
        if source in _libs:
            return _libs[source]
        with open(source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS + tuple(libs)).encode()).hexdigest()[:16]
        stem = os.path.splitext(os.path.basename(source))[0]
        path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
        if not os.path.exists(path):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {source} is built with g++ at first use")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            res = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, source, *libs], capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {source}:\n{res.stderr}")
            os.replace(tmp, path)
        _libs[source] = ctypes.CDLL(path)
        return _libs[source]


def check(rc: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
