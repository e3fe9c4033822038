"""Build and load the port's CUDA kernels.

Each `vdetr_tpu_torch/csrc/<name>.cu` has a plain C interface; device
code shared by several sources sits in `csrc/*.cuh` headers. At first
use it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `build/kernels/` at the repository root and loaded with ctypes.
The library name carries a hash of the source, the headers and the
flags, so an edited source is rebuilt and an unchanged one is reused;
ptxas's report of each kernel's registers and spills is kept beside it
(`build_log`).

Nothing here runs at import time: the package imports on machines
without nvcc or a GPU, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
               "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures: every entry returns cudaGetLastError() as an int.
_SIGNATURES = {
    "keyed_conv": ("keyed_conv_f32",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _I, _I, _P]),
    "keyed_conv_dw": ("keyed_conv_dw_f32",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P]),
    "map_kernel": ("kernel_map_i32",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "mapped_conv": ("mapped_conv_f32",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "mapped_conv_dw": ("mapped_conv_dw_f32",
                       [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P]),
    "fps": ("fps_f32", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "rpe_attention": ("rpe_cross_attention_f32",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _F, _I, _P]),
    "rpe_attention_bwd": ("rpe_cross_attention_bwd_f32",
                          [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _F, _I, _I, _F, _I, _I, _I, _P]),
    "rpe_table_sum": ("rpe_table_sum_f32", [_P, _P, _I, _I, _P]),
    "rpe_ablate": ("rpe_ablate_f32",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                    _F, _I, _P]),
    "dot_micro": ("dot_micro_f32", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "nms": ("nms_samecls_f32",
            [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P]),
    "auction": ("auction_f32", [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]),
    "rotated_iou": ("rotated_areas_f32",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}

# Entries beyond a source's first: name -> (source, C function, argtypes).
# The bf16 forms of the sparse convs are second entries of their f32
# forms' sources, instantiations of the same templated bodies.
_CONV = _SIGNATURES["keyed_conv"][1]
_CONV_DW = _SIGNATURES["keyed_conv_dw"][1]
_EXTRA = {
    "keyed_conv_bf16": ("keyed_conv", "keyed_conv_bf16", _CONV),
    "keyed_conv_dw_bf16": ("keyed_conv_dw", "keyed_conv_dw_bf16", _CONV_DW),
    "mapped_conv_bf16": ("mapped_conv", "mapped_conv_bf16",
                         _SIGNATURES["mapped_conv"][1]),
    "mapped_conv_dw_bf16": ("mapped_conv_dw", "mapped_conv_dw_bf16",
                            _SIGNATURES["mapped_conv_dw"][1]),
}


def _entry(name: str):
    """(source, C function, argtypes) of kernel entry `name`."""
    if name in _EXTRA:
        return _EXTRA[name]
    fn_name, argtypes = _SIGNATURES[name]
    return name, fn_name, argtypes


_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    # the shared headers are part of every source's digest
    src = b"".join(p.read_bytes() for p in
                   [_CSRC / f"{name}.cu"] + sorted(_CSRC.glob("*.cuh")))
    flags = " ".join(_NVCC_FLAGS).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile_cmd(name: str, out: Path):
    return ([nvcc_path()] + _NVCC_FLAGS
            + ["-o", str(out), str(_CSRC / f"{name}.cu")])


def build_all() -> Dict[str, Path]:
    """Compile every kernel that is not built yet, all at once (one nvcc
    process per source, in parallel). Returns {name: library path}.
    Raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in _SIGNATURES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_compile_cmd(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out.decode(errors='replace')}")
            continue
        paths[name].with_suffix(".log").write_bytes(out)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output from building kernel `name` (ptxas's registers, stack
    and spill bytes per kernel); empty if it was not built here."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel entry `name` (its source's), built on
    first use, with the entry's C function typed."""
    source, fn_name, argtypes = _entry(name)
    lib = _loaded.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all()
        lib = _loaded[source] = ctypes.CDLL(str(path))
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(t, dtype, shape, name: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and
    `shape`: the kernels take raw pointers and trust both."""
    if not (t.is_cuda and t.dtype == dtype and tuple(t.shape) == tuple(shape)
            and t.is_contiguous()):
        raise ValueError(
            f"{name}: want a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f" (contiguous={t.is_contiguous()})")


def call(name: str, *args) -> None:
    """Launch kernel `name` with C arguments; raise on a CUDA error."""
    fn_name = _entry(name)[1]
    err = getattr(load(name), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {fn_name}")
