"""ctypes binding for the native sim engine (``sim/native/dasasim.cpp``).

Counterpart of ``dasa_tpu/sim/csim.py``: :class:`NativeEngine`'s batched
reset / step / fill_obs calls replace the Python per-episode loops of the
host env.  Its geometry is the Python engine's (``sim/engine.py``;
``tests/test_torch_native_sim.py`` holds the two together).

The library builds with ``make`` at first use, from this package's own
copy of the source, into the git-ignored ``dasa_tpu_torch/_build/`` under
a name keyed by a hash of the source and the Makefile, so an edited
source rebuilds.  A file lock keeps concurrent processes (test workers,
ranks) from building twice, and the library moves into place with an
atomic rename.  Nothing loads the JAX package's ``libdasasim.so``.
"""

from __future__ import annotations

import ctypes as C
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_LOCK = threading.Lock()
_LIB = None
# seconds make took, when this process built the library (else None)
build_seconds: Optional[float] = None


def _digest() -> str:
    h = hashlib.sha256()
    for name in ("dasasim.cpp", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdasasim_{_digest()}.so"


def build() -> Path:
    """Build the library unless one for the current source exists; returns
    its path.  Raises with make's output when the build fails."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "dasasim.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run(["make", "-s", "-C", str(NATIVE_DIR),
                               f"OUT={tmp}"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0 or not tmp.exists():
            raise RuntimeError(f"building the native sim engine failed "
                               f"(make exit {proc.returncode}):\n"
                               f"{proc.stdout}")
        os.replace(tmp, path)
        build_seconds = time.perf_counter() - start
    return path


def load_library() -> C.CDLL:
    """The loaded library (built on first use); raises when it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = C.CDLL(str(build()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.dasasim_create.restype = C.c_void_p
        lib.dasasim_create.argtypes = [C.c_int]
        lib.dasasim_destroy.argtypes = [C.c_void_p]
        lib.dasasim_load_scan.restype = C.c_int
        lib.dasasim_load_scan.argtypes = [C.c_void_p, C.c_char_p]
        lib.dasasim_num_nodes.restype = C.c_int
        lib.dasasim_num_nodes.argtypes = [C.c_void_p, C.c_int]
        lib.dasasim_node_index.restype = C.c_int
        lib.dasasim_node_index.argtypes = [C.c_void_p, C.c_int, C.c_char_p]
        lib.dasasim_node_id.restype = C.c_char_p
        lib.dasasim_node_id.argtypes = [C.c_void_p, C.c_int, C.c_int]
        lib.dasasim_set_feat_rows.argtypes = [C.c_void_p, C.c_int, i32p]
        lib.dasasim_distance.restype = C.c_float
        lib.dasasim_distance.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                         C.c_int]
        lib.dasasim_next_hop.restype = C.c_int
        lib.dasasim_next_hop.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                         C.c_int]
        lib.dasasim_shortest_path.restype = C.c_int
        lib.dasasim_shortest_path.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                              C.c_int, i32p, C.c_int]
        lib.dasasim_candidates.argtypes = [
            C.c_void_p, C.c_int, C.c_int, i32p, i32p, f32p, f32p, f32p,
            i32p]
        lib.dasasim_reset.argtypes = [C.c_void_p, C.c_int, i32p, i32p,
                                      i32p, i32p, f64p]
        lib.dasasim_step.argtypes = [C.c_void_p, C.c_int, i32p]
        lib.dasasim_teleport.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                         C.c_int]
        lib.dasasim_get_state.argtypes = [C.c_void_p, C.c_int, i32p, i32p,
                                          i32p, i32p]
        lib.dasasim_fill_obs.argtypes = [
            C.c_void_p, C.c_int, C.c_int, i32p, i32p, f32p, f32p, i32p,
            i32p, f32p, f32p, i32p, i32p, i32p, f32p, f32p]
        _LIB = lib
        return _LIB


class NativeEngine:
    """One engine instance: scan graphs + a batch of episodes."""

    def __init__(self, k_max: int = 16):
        self.lib = load_library()
        self.handle = C.c_void_p(self.lib.dasasim_create(k_max))
        self.k_max = k_max
        self._scan_handles: Dict[str, int] = {}
        self._batch = 0

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.dasasim_destroy(self.handle)
        except Exception:
            pass

    def load_scan(self, scan_id: str, connectivity_dir: str) -> int:
        if scan_id in self._scan_handles:
            return self._scan_handles[scan_id]
        path = os.path.join(connectivity_dir,
                            f"{scan_id}_connectivity.json")
        idx = self.lib.dasasim_load_scan(self.handle, path.encode())
        if idx < 0:
            raise RuntimeError(f"failed to load {path}")
        self._scan_handles[scan_id] = idx
        return idx

    def num_nodes(self, scan: int) -> int:
        return self.lib.dasasim_num_nodes(self.handle, scan)

    def node_index(self, scan: int, vid: str) -> int:
        return self.lib.dasasim_node_index(self.handle, scan, vid.encode())

    def node_id(self, scan: int, node: int) -> str:
        return self.lib.dasasim_node_id(self.handle, scan, node).decode()

    def set_feat_rows(self, scan: int, rows: np.ndarray) -> None:
        self.lib.dasasim_set_feat_rows(
            self.handle, scan, np.ascontiguousarray(rows, np.int32))

    def distance(self, scan: int, a: int, b: int) -> float:
        return self.lib.dasasim_distance(self.handle, scan, a, b)

    def next_hop(self, scan: int, a: int, b: int) -> int:
        return self.lib.dasasim_next_hop(self.handle, scan, a, b)

    def shortest_path(self, scan: int, a: int, b: int,
                      cap: int = 1024) -> np.ndarray:
        out = np.empty(cap, np.int32)
        n = self.lib.dasasim_shortest_path(self.handle, scan, a, b, out,
                                           cap)
        if n < 0:
            raise ValueError("no path")
        return out[:n]

    def candidates(self, scan: int, node: int):
        k = self.k_max
        nbr = np.empty(k, np.int32)
        point = np.empty(k, np.int32)
        nh = np.empty(k, np.float32)
        elev = np.empty(k, np.float32)
        rd = np.empty(k, np.float32)
        n = np.empty(1, np.int32)
        self.lib.dasasim_candidates(self.handle, scan, node, nbr, point,
                                    nh, elev, rd, n)
        m = int(n[0])
        return nbr[:m], point[:m], nh[:m], elev[:m], rd[:m]

    def reset(self, scans: np.ndarray, starts: np.ndarray,
              path0s: np.ndarray, goals: np.ndarray,
              headings: np.ndarray) -> None:
        self._batch = len(scans)
        self.lib.dasasim_reset(
            self.handle, self._batch,
            np.ascontiguousarray(scans, np.int32),
            np.ascontiguousarray(starts, np.int32),
            np.ascontiguousarray(path0s, np.int32),
            np.ascontiguousarray(goals, np.int32),
            np.ascontiguousarray(headings, np.float64))

    def step(self, actions: np.ndarray) -> None:
        self.lib.dasasim_step(self.handle, self._batch,
                              np.ascontiguousarray(actions, np.int32))

    def teleport(self, i: int, node: int, view: int) -> None:
        self.lib.dasasim_teleport(self.handle, i, node, view)

    def get_state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        b = self._batch
        scan = np.empty(b, np.int32)
        node = np.empty(b, np.int32)
        view = np.empty(b, np.int32)
        step = np.empty(b, np.int32)
        self.lib.dasasim_get_state(self.handle, b, scan, node, view, step)
        return scan, node, view, step

    def fill_obs(self, K: int) -> dict:
        b = self._batch
        out = {
            "feat_row": np.empty(b, np.int32),
            "view_index": np.empty(b, np.int32),
            "heading": np.empty(b, np.float32),
            "elevation": np.empty(b, np.float32),
            "cand_point_id": np.empty((b, K), np.int32),
            "cand_nbr_ix": np.empty((b, K), np.int32),
            "cand_heading": np.empty((b, K), np.float32),
            "cand_elevation": np.empty((b, K), np.float32),
            "cand_n": np.empty(b, np.int32),
            "teacher": np.empty(b, np.int32),
            "back_teacher": np.empty(b, np.int32),
            "distance": np.empty(b, np.float32),
            "progress": np.empty(b, np.float32),
        }
        self.lib.dasasim_fill_obs(
            self.handle, b, K, out["feat_row"], out["view_index"],
            out["heading"], out["elevation"],
            out["cand_point_id"].reshape(-1),
            out["cand_nbr_ix"].reshape(-1),
            out["cand_heading"].reshape(-1),
            out["cand_elevation"].reshape(-1), out["cand_n"],
            out["teacher"], out["back_teacher"], out["distance"],
            out["progress"])
        return out
