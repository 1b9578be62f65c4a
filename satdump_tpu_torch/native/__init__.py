"""Native (C) codecs for host-side bit-serial work, loaded with ctypes.

The codecs whose inner loops are sample-serial and too hot for Python are
small C files compiled with the system C compiler at first use, never at
import: the Rice decoder (`rice.c`), the 12-bit JPEG and the wavelet codecs
(`jpeg12.c`, `decompwt.c`; hardened copies of the JAX package's) and the
port's own JPEG 2000 decoder (`j2k.c`). It builds as the CUDA
sources do (`ops/cuda/_build.py`): into `_build/lib<name>-<hash>.so`, the
hash covering the source and the flags, so an edited source is rebuilt. A
missing compiler or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from satdump_tpu_torch.core.exceptions import SatdumpError

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
# no fused multiply-adds: the float code (jpeg12.c's IDCT, j2k.c's 9/7)
# rounds the same on every host the card's machine may have
CC_FLAGS = ["-O2", "-ffp-contract=off", "-shared", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(SatdumpError):
    pass


def cc_path() -> str:
    cc = shutil.which(os.environ.get("CC", "cc"))
    if not cc:
        raise NativeBuildError("no C compiler found (cc, or $CC, on PATH)")
    return cc


def _target(name: str) -> Path:
    src = NATIVE_DIR / f"{name}.c"
    h = hashlib.sha256(src.read_bytes() + " ".join(CC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def get_lib(name: str) -> ctypes.CDLL:
    """The loaded library of native/<name>.c, compiled first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    so = _target(name)
    if not so.exists():
        cc = cc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        p = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp),
                            str(NATIVE_DIR / f"{name}.c")],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise NativeBuildError(f"{cc} failed for {name}.c "
                                   f"(rc {p.returncode}):\n{p.stderr}")
        os.replace(tmp, so)
    lib = _libs[name] = ctypes.CDLL(str(so))
    return lib
