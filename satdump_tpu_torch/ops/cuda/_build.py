"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (the hash covers the source and the flags, so
an edited source is rebuilt). The build runs at first use, from the repo's
sources only; `build()` starts one nvcc per source, all at once. A missing
nvcc or a failed compile raises: there is no fallback. `Kernel` is the launch
path the wrappers share.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

from satdump_tpu_torch.core.exceptions import SatdumpError

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("viterbi_re", "resample_arith", "probe_affine", "sample_walk",
           "mm_clock", "turbo_bcjr", "viterbi_block", "gardner_clock",
           "resample_strip")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
ptxas_log: Dict[str, str] = {}     # nvcc's -Xptxas -v report per source


class KernelBuildError(SatdumpError):
    pass


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns seconds per compiled source."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    secs, failed = {}, []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        ptxas_log[n] = log
        if p.returncode != 0:
            failed.append(f"{n}.cu (rc {p.returncode}):\n{log}")
            continue
        os.replace(tmp, _target(n))
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


class Kernel:
    """The entry `<entry>_launch(..., stream)` of csrc/<name>.cu (`entry`
    defaults to `name`), which returns a cudaError_t, loaded (and built if
    needed) at its first call.

    `kernel(device_index, *args)` launches it on that device's current
    stream: the stream's raw handle is read once, the device is made current
    only when it is not already, and a nonzero error raises.
    """

    def __init__(self, name: str, argtypes: Sequence, entry: str = ""):
        self.name = name
        self.entry = entry or name
        self._argtypes = [*argtypes, ctypes.c_void_p]       # the stream
        self._fn = None

    def _load(self):
        lib = load(self.name)
        fn = getattr(lib, f"{self.entry}_launch")
        fn.argtypes = self._argtypes
        fn.restype = ctypes.c_int
        self._lib, self._fn = lib, fn
        return fn

    def __call__(self, device_index: int, *args) -> None:
        fn = self._fn or self._load()
        if device_index == torch._C._cuda_getDevice():
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device_index))
        else:
            with torch.cuda.device(device_index):
                err = fn(*args,
                         torch._C._cuda_getCurrentRawStream(device_index))
        if err:
            msg = getattr(self._lib, f"{self.name}_error_string")(err)
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {err} "
                               f"({msg.decode()})")
