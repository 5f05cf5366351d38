"""The native (C++) annealer and its ctypes bindings.

Port of ``safelife_tpu/native/__init__.py:28-76``. ``annealer.cpp`` here is
a byte-identical copy of ``safelife_tpu/native/annealer.cpp``: built with
the same ``g++`` flags on one host, both packages anneal alike, so equal
seeds give equal levels.

The library is built with ``g++`` at first use (never at import) into
``native/_build/`` (listed in ``.gitignore``), named by a hash of the
source and the flags, so a second call in the same checkout reuses it.
Each build writes a temporary file and renames it, so processes building
at once never load a partial library.

Unlike the JAX package, a failed build raises: nothing falls back to the
Python annealer unless asked. The Python annealer draws another random
stream than the C++ one, so a silent fallback would change every level of
a run. Set ``SAFELIFE_TPU_TORCH_NO_NATIVE=1`` (or pass ``native=False`` to
:func:`~safelife_tpu_torch.procgen.pattern.gen_pattern` and
:func:`~safelife_tpu_torch.procgen.pattern.wrapped_label`) to run the slow
Python annealer instead.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "annealer.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
#: Set to a non-empty value to run the Python annealer instead.
NO_NATIVE_ENV = "SAFELIFE_TPU_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib = None


def requested():
    """Whether the native annealer is to run (unless the caller says)."""
    return not os.environ.get(NO_NATIVE_ENV)


def library_path():
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "annealer-%s.so" % h.hexdigest()[:16])


def _build(lib):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, SOURCE]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("cannot run g++ to build the native annealer: %s"
                           % e) from e
    if out.returncode != 0:
        raise RuntimeError("g++ failed to build the native annealer (exit "
                           "%d):\n%s" % (out.returncode, out.stderr))
    os.replace(tmp, lib)


def load():
    """The native library, built first if needed. Raises ``RuntimeError``
    when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.sl_gen_pattern.restype = ctypes.c_int
        lib.sl_gen_pattern.argtypes = [
            ctypes.c_void_p,  # layers uint16*
            ctypes.c_void_p,  # mask int32*
            ctypes.c_void_p,  # seeds int32*
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # period, rows, cols
            ctypes.c_double, ctypes.c_double,  # max_iter, min_fill
            ctypes.c_double, ctypes.c_double,  # temperature, osc_bonus
            ctypes.c_void_p,  # penalties double[8]
            ctypes.c_uint64,  # seed
        ]
        lib.sl_wrapped_label.restype = ctypes.c_int
        lib.sl_wrapped_label.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib
