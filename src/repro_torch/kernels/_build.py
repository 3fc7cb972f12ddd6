"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``.  Libraries go to ``build/kernels/`` at the root of
the checkout, named by a hash of their source, and are built at first
use: nothing is compiled when a module is imported, and a changed source
builds anew.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -O3 and IEEE arithmetic: no --use_fast_math (see the division rules in
# csrc/int8_codec.cu and csrc/sign_codec.cu, the add rule of
# csrc/topk_reduce.cu, and the exactness notes of csrc/flash_attention.cu,
# csrc/ssd_scan.cu and csrc/rglru_scan.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C signatures of every entry point, by source
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "int8_codec": {
        "hsgd_int8_quantize": (_P, _P, _P, _I64, _I64, _I32, _P),
        "hsgd_int8_scale_quantize": (_P, _P, _P, _I64, _I64, _I32, _P),
        "hsgd_int8_dequantize": (_P, _P, _P, _I64, _I64, _I32, _P),
    },
    "sign_codec": {
        "hsgd_sign_pack": (_P, _P, _P, _I64, _I64, _I32, _P),
        "hsgd_sign_unpack": (_P, _P, _P, _I64, _I64, _I32, _P),
    },
    "topk_reduce": {
        "hsgd_topk_decode_reduce": (_P, _P, _P, _I64, _I64, _I64, _P, _I64,
                                    _P),
    },
    "flash_attention": {
        "hsgd_flash_attention": (_P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                 _I32, _I32, _I32, _I32, _I32, _P),
    },
    "ssd_scan": {
        "hsgd_ssd_scan": (_P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                          _I32, _I32, _I32, _I64, _I64, _I64, _I64, _I64,
                          _I64, _P),
    },
    "rglru_scan": {
        "hsgd_rglru_scan": (_P, _P, _P, _I32, _I32, _I32, _P),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this exact source is
    already built; returns its path.  ``verbose`` adds ``-Xptxas -v`` and
    prints what the compiler says (registers, spills) to stderr."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.is_file() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, file=sys.stderr, end="")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at first use), with
    ``argtypes``/``restype`` declared for every entry point."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, args in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(args)
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib
