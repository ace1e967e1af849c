"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` file compiles on its own into a shared library with a
plain ``extern "C"`` interface (no PyTorch headers and no CUTLASS, so a build
takes seconds; the bf16 kernels reach the CUDA driver's tensor-map encoder
through the runtime, so nothing links ``-lcuda``), all sources in parallel,
into ``build/kernels/`` under the checkout (listed in ``.gitignore``).  A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.  Nothing
is built when a module is imported: the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_fwd.cu", "flash_fwd_sm90.cu", "flash_bwd.cu", "flash_dq_sm90.cu",
           "flash_dkv_sm90.cu", "flash_update.cu", "flash_update_sm90.cu")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the "
                           "CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == source or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def library_path(source: str) -> str:
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{_digest(source)}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source that has no up-to-date library, one ``nvcc`` each,
    all started together.  Returns {source: {path, seconds, log}}, the log
    being the compiler's ptxas report (kept beside the library, so a cached
    build reports it too); raises with the compiler's output when a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    out: Dict[str, dict] = {}
    for src in sources:
        path = library_path(src)
        if os.path.exists(path) and os.path.exists(f"{path}.log"):
            with open(f"{path}.log") as f:  # the compiler's report, kept beside the library
                out[src] = {"path": path, "seconds": 0.0, "log": f.read()}
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), time.perf_counter(), tmp, path)
    failed: List[str] = []
    for src, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {src} exited {proc.returncode}:\n{log}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", f"{path}.log")  # the log first: a library implies its log
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
        out[src] = {"path": path, "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def ptxas_usage(log: str) -> Dict[str, dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: {mangled name: {registers,
    stack, spill_stores, spill_loads}} (bytes for the last three)."""
    usage: Dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m[1])
    return usage


def kernel_label(mangled: str) -> str:
    """A readable name for a mangled kernel: ``flash_fwd_sm90_kernel<bf16, 64>``."""
    m = re.search(r"\d+(flash_\w+?_kernel)I(.*)E", mangled)
    if not m:
        return mangled
    name, args = m.groups()
    d = re.search(r"Li(\d+)E", args)
    dtype = "bf16" if ("bfloat16" in args or "sm90" in name) else "fp32"
    return f"{name}<{dtype}, {d.group(1) if d else '?'}>"


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float
# argtypes of each extern "C" entry point (csrc/*.cu); pointers and the
# stream travel as c_void_p, never as a 32-bit int
_SIGNATURES = {
    "flash_fwd": ("flash_fwd.cu", [_PTR] * 5 + [_INT] * 5 + [_FLOAT, _PTR, _PTR]),
    "flash_fwd_sm90": ("flash_fwd_sm90.cu", [_PTR] * 5 + [_INT] * 5 + [_FLOAT, _PTR, _PTR]),
    "flash_bwd_dq": ("flash_bwd.cu", [_PTR] * 7 + [_INT] * 5 + [_FLOAT, _PTR, _PTR]),
    "flash_dq_sm90": ("flash_dq_sm90.cu", [_PTR] * 7 + [_INT] * 5 + [_FLOAT, _PTR, _PTR]),
    "flash_bwd_dkv": ("flash_bwd.cu", [_PTR] * 8 + [_INT] * 5 + [_FLOAT, _PTR, _PTR]),
    "flash_dkv_sm90": ("flash_dkv_sm90.cu", [_PTR] * 8 + [_INT] * 5 + [_FLOAT, _PTR, _PTR]),
    "flash_update": ("flash_update.cu", [_PTR] * 11 + [_INT] * 6 + [_FLOAT, _PTR, _PTR]),
    "flash_update_sm90": ("flash_update_sm90.cu", [_PTR] * 11 + [_INT] * 6 + [_FLOAT, _PTR, _PTR]),
}


class KernelLibrary:
    """The bound entry points: ``lib.flash_fwd(...)`` etc. return the launch's
    ``cudaError_t`` as an int."""

    def __init__(self, builds: Dict[str, dict]):
        self.builds = builds
        self._dlls = {src: ctypes.CDLL(info["path"]) for src, info in builds.items()}
        for name, (src, argtypes) in _SIGNATURES.items():
            fn = getattr(self._dlls[src], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


_LIBRARY: List[KernelLibrary] = []


def load() -> KernelLibrary:
    """Build (if needed) and bind the kernels once per process."""
    if not _LIBRARY:
        _LIBRARY.append(KernelLibrary(build()))
    return _LIBRARY[0]
