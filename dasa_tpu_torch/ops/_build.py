"""Build and load the hand-written CUDA kernels of ``dasa_tpu_torch/csrc``.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, into an object file; the objects link into one shared
library with a plain C interface that :func:`library` loads with
``ctypes``.  Nothing compiles at import time: the first kernel call builds
(or finds) the library.  The build lands in ``dasa_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of the sources, headers and
flags, so an edited source rebuilds and an unchanged tree reuses the
library.  A file lock keeps concurrent processes from building twice.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# dynamic shared memory one block may use on sm_90
MAX_SMEM = 232448
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (pointers, ints, then the stream)
ENTRY_POINTS = {
    "dasa_lstm_fwd": [_P] * 11 + [_I] * 5 + [_P],
    "dasa_lstm_fwd_smem": [_I] * 4,
    "dasa_lstm_bwd": [_P] * 11 + [_I] * 5 + [_P],
    "dasa_lstm_bwd_smem": [_I] * 5,
    "dasa_adain_gate": [_P] * 6 + [_I] * 4 + [_P],
    "dasa_adain_gate_smem": [_I],
    "dasa_shift_attend": [_P] * 9 + [_I] * 6 + [_P],
    "dasa_shift_attend_smem": [_I] * 5,
}

_lib: Optional[ctypes.CDLL] = None
_counters: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc") if cuda_home
                  else None, shutil.which("nvcc"),
                  "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "dasa_tpu_torch build only where the CUDA toolkit is installed")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdasa_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link the library, unless a
    library for the current sources exists.  Returns its path; the
    compiler's register/spill report goes to a ``.log`` beside it."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        nvcc = _nvcc()
        tag = lib_path.stem.rsplit("_", 1)[-1]
        jobs = []
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _obj, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = lib_path.with_suffix(".so.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        lib_path.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dasa_error_string.argtypes = [ctypes.c_int]
        lib.dasa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().dasa_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` u32 readiness counters, 128 bytes apart, zero between launches:
    made once per device and stream, and left at zero by every kernel that
    uses them (their launches on one stream run one after another)."""
    key = (t.device, stream_of(t), n)
    buf = _counters.get(key)
    if buf is None:
        buf = torch.zeros(n * 32, dtype=torch.int32, device=t.device)
        _counters[key] = buf
    return buf


def sm_count(t: torch.Tensor) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def require_cuda(name: str, **tensors: torch.Tensor) -> None:
    """The kernels take bf16 CUDA tensors on one device, each 16-byte
    aligned; anything else is refused."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(
                f"{name}: {key} is {t.dtype}; the CUDA kernel takes "
                "bfloat16 (set use_pallas='never' for other dtypes)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, copied when it is not: a view
    into a stacked tensor can start mid-vector (the second direction's
    (T, B) bf16 mask of a BiLSTM starts 2 T B bytes in, at T 35, B 20 not
    a multiple of 16)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The raw kernel entry points return tensors without a ``grad_fn``:
    with grad mode on they refuse inputs that require grad, rather than
    silently cut the graph.  Differentiable code calls the
    ``torch.autograd.Function`` of the op."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the raw entry point would "
            "detach it; call the op's autograd Function instead")
