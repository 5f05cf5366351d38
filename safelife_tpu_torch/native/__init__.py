"""The native (C++) libraries and their ctypes bindings: the level
generator's annealer (``annealer.cpp``) and the exact earth mover's distance
(``emd.cpp``).

Port of ``safelife_tpu/native/__init__.py:28-76``. ``annealer.cpp`` here is
a byte-identical copy of ``safelife_tpu/native/annealer.cpp``: built with
the same ``g++`` flags on one host, both packages anneal alike, so equal
seeds give equal levels. ``emd.cpp`` is the port's own network simplex,
the exact branch of :func:`~safelife_tpu_torch.side_effects.emd_hat`.

Each library is built with ``g++`` at first use (never at import) into
``native/_build/`` (listed in ``.gitignore``), named by its source's name
and a hash of the source and the flags, so a second call in the same
checkout reuses it. Each build writes a temporary file and renames it, so
processes building at once never load a partial library.

Unlike the JAX package, a failed build raises: nothing falls back to the
Python annealer unless asked, nor to an LP solver. The Python annealer
draws another random stream than the C++ one, so a silent fallback would
change every level of a run. Set ``SAFELIFE_TPU_TORCH_NO_NATIVE=1`` (or pass
``native=False`` to :func:`~safelife_tpu_torch.procgen.pattern.gen_pattern`
and :func:`~safelife_tpu_torch.procgen.pattern.wrapped_label`) to run the
slow Python annealer instead; the EMD has no other solver.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
#: Set to a non-empty value to run the Python annealer instead.
NO_NATIVE_ENV = "SAFELIFE_TPU_TORCH_NO_NATIVE"

_P = ctypes.c_void_p
#: Each library's functions: (return type, argument types).
PROTOTYPES = {
    "annealer": {
        "sl_gen_pattern": (ctypes.c_int, [
            _P,  # layers uint16*
            _P,  # mask int32*
            _P,  # seeds int32*
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # period, rows, cols
            ctypes.c_double, ctypes.c_double,  # max_iter, min_fill
            ctypes.c_double, ctypes.c_double,  # temperature, osc_bonus
            _P,  # penalties double[8]
            ctypes.c_uint64,  # seed
        ]),
        "sl_wrapped_label": (ctypes.c_int, [_P, _P, ctypes.c_int,
                                            ctypes.c_int]),
    },
    "emd": {
        "sl_emd_hat": (ctypes.c_int, [
            ctypes.c_int, ctypes.c_int,  # n, m
            _P, _P, _P,  # a double[n], b double[m], dist double[n * m]
            _P,  # cost double*
        ]),
    },
}

_lock = threading.Lock()
_libs = {}


def requested():
    """Whether the native annealer is to run (unless the caller says)."""
    return not os.environ.get(NO_NATIVE_ENV)


def _source(name):
    return os.path.join(_DIR, name + ".cpp")


def library_path(name="annealer"):
    """Where library ``name`` of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_source(name), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def _build(name, lib):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib, os.getpid())
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, _source(name)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError("cannot run g++ to build the native %s: %s"
                           % (name, e)) from e
    if out.returncode != 0:
        raise RuntimeError("g++ failed to build the native %s (exit %d):\n%s"
                           % (name, out.returncode, out.stderr))
    os.replace(tmp, lib)


def load(name="annealer"):
    """Native library ``name`` (a key of :data:`PROTOTYPES`), built first
    if needed. Raises ``RuntimeError`` when it cannot be built."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not os.path.exists(path):
            _build(name, path)
        lib = ctypes.CDLL(path)
        for fn, (restype, argtypes) in PROTOTYPES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
        return lib
