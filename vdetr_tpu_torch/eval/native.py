"""ctypes binding and build at first use of the native (C++) rotated IoU
the AP evaluator scores with (counterpart of `vdetr_tpu/eval/native.py`).

`vdetr_tpu_torch/csrc/box_iou.cpp` is compiled with `g++ -O3 -shared
-fPIC` into `build/kernels/` beside the CUDA libraries, the file name
keyed by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one reused. This is host code: without a
compiler the evaluator falls back to the numpy IoU, as the JAX package
does, and `iou_path()` says which of the two scores.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from vdetr_tpu_torch.kernels import BUILD_DIR

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "box_iou.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbox_iou_{digest}.so"


def _build(path: Path) -> bool:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++"] + _FLAGS + ["-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    os.replace(tmp, path)  # atomic: a concurrent build sees all or none
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without a compiler."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    lib.box3d_iou_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.box3d_iou_pairs.restype = None
    _lib = lib
    return _lib


def iou_path() -> str:
    """Which rotated IoU the evaluator scores with: "native (<library>)"
    or "numpy" (no compiler)."""
    return (f"native ({lib_path().name})" if get_lib() is not None
            else "numpy")


def box3d_iou_pairs(dets: np.ndarray, gts: np.ndarray) -> Optional[np.ndarray]:
    """(nd, 8, 3) x (ng, 8, 3) -> (nd, ng) rotated 3D IoU, or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dets = np.ascontiguousarray(dets, np.float32)
    gts = np.ascontiguousarray(gts, np.float32)
    out = np.zeros((dets.shape[0], gts.shape[0]), np.float32)
    lib.box3d_iou_pairs(
        dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dets.shape[0],
        gts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), gts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
