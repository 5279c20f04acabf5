"""Build and load the CUDA kernels: ``nvcc`` → one shared library per
source with a plain C interface, loaded with ``ctypes``.

The build runs at first use, into ``build/kernels/`` at the root of the
checkout (``.gitignore`` lists ``build/``); :func:`build_all` starts one
``nvcc`` per source, all at once.  Each library's name carries a hash of
what built it (:func:`lib_path`), so a changed source, flag or compiler
rebuilds it.  A missing ``nvcc`` or a failed build raises — there is no
fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fused_decode", "fused_ffn", "fused_head", "fused_mla_decode",
           "rwkv6_scan", "flash_decode", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def _nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True).stdout


def lib_path(name: str, nvcc: str) -> Path:
    """``lib<name>-<key>.so``: the key hashes the source, every header in
    ``csrc/`` (``*.cuh``), the flags, this file and the compiler's
    version, so a library built from anything else is never loaded."""
    h = hashlib.sha256()
    for part in (" ".join(NVCC_FLAGS), _nvcc_version(nvcc)):
        h.update(part.encode())
    headers = sorted(CSRC.glob("*.cuh"))
    for f in (CSRC / f"{name}.cu", *headers, Path(__file__)):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, in parallel;
    returns ``{name: ptxas log}`` (registers, shared memory, spills) for
    what was built."""
    nvcc = _nvcc()
    todo = [n for n in names if not lib_path(n, nvcc).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    logs, failed = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, lib_path(n, nvcc))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n][-4000:] for n in failed))
    return logs


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry ``symbol`` of library ``name`` (built first if missing),
    with its ``argtypes`` set — ``c_void_p`` for every pointer and the
    stream, or ctypes would pass them as 32-bit ints."""
    key = (name, symbol)
    with _lock:
        if key not in _fns:
            if name not in _libs:
                build_all((name,))
                _libs[name] = ctypes.CDLL(str(lib_path(name, _nvcc())))
            fn = getattr(_libs[name], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[key] = fn
        return _fns[key]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(name: str, tensors: Dict[str, torch.Tensor],
            dtypes: Dict[str, torch.dtype]) -> None:
    """Raise unless every tensor is contiguous, on the first one's device
    and of the dtype ``dtypes`` names for it."""
    dev = next(iter(tensors.values())).device
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.dtype != dtypes[key]:
            raise NotImplementedError(
                f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")
