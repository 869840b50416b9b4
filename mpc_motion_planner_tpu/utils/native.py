"""ctypes bindings for the native (C++) runtime components.

The shared library lives in ``native/`` and is built with cmake+ninja (or a
direct g++ fallback) on first use, and rebuilt whenever ``native/otg.cpp``
is newer than it, so the library always comes from the committed source.
Currently exposed:

* ``otg_plan`` / ``otg_sample``: the C++ jerk-limited OTG — the framework's
  native counterpart to the reference's Ruckig dependency. Used as a
  host-side low-latency single-shot path and as an independent oracle for
  the JAX implementation in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_NAME = "libmpcplanner_native.so"
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    build_dir = os.path.join(_NATIVE_DIR, "build")
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, _LIB_NAME)
    src = os.path.join(_NATIVE_DIR, "otg.cpp")
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(src):
        return lib_path
    try:
        subprocess.run(
            ["cmake", "-GNinja", "-DCMAKE_BUILD_TYPE=Release", ".."],
            cwd=build_dir, check=True, capture_output=True,
        )
        subprocess.run(["ninja"], cwd=build_dir, check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        # direct g++ fallback
        subprocess.run(
            [
                "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                src, "-o", lib_path,
            ],
            check=True, capture_output=True,
        )
    return lib_path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        dp = ctypes.POINTER(ctypes.c_double)
        lib.otg_plan.argtypes = [ctypes.c_int32] + [dp] * 7 + [dp, dp, dp]
        lib.otg_plan.restype = None
        lib.otg_sample.argtypes = (
            [ctypes.c_int32, ctypes.c_int32, dp, ctypes.c_double]
            + [dp] * 4
            + [dp] * 3
        )
        lib.otg_sample.restype = None
        _lib = lib
    return _lib


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def plan_trajectory_native(
    p0, v0, pf, vf, vmax, amax, jmax
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Plan one synchronized trajectory on the host.

    Returns (duration, phase_dt (nj, 7), phase_jerk (nj, 7))."""
    lib = load()
    arrs = [np.ascontiguousarray(np.asarray(a, np.float64)) for a in
            (p0, v0, pf, vf, vmax, amax, jmax)]
    nj = arrs[0].shape[0]
    duration = np.zeros(1)
    phase_dt = np.zeros((nj, 7))
    phase_jerk = np.zeros((nj, 7))
    lib.otg_plan(
        nj, *map(_cptr, arrs), _cptr(duration), _cptr(phase_dt), _cptr(phase_jerk)
    )
    return float(duration[0]), phase_dt, phase_jerk


def sample_native(times, duration, p0, v0, phase_dt, phase_jerk):
    """Sample a planned trajectory at `times`; returns (p, v, a) (nt, nj)."""
    lib = load()
    times = np.ascontiguousarray(np.asarray(times, np.float64))
    p0 = np.ascontiguousarray(np.asarray(p0, np.float64))
    v0 = np.ascontiguousarray(np.asarray(v0, np.float64))
    phase_dt = np.ascontiguousarray(np.asarray(phase_dt, np.float64))
    phase_jerk = np.ascontiguousarray(np.asarray(phase_jerk, np.float64))
    nj = p0.shape[0]
    nt = times.shape[0]
    p = np.zeros((nt, nj))
    v = np.zeros((nt, nj))
    a = np.zeros((nt, nj))
    lib.otg_sample(
        nj, nt, _cptr(times), float(duration), _cptr(p0), _cptr(v0),
        _cptr(phase_dt), _cptr(phase_jerk), _cptr(p), _cptr(v), _cptr(a),
    )
    return p, v, a
