"""Builds the CUDA kernels of ``ops/csrc`` at first use and binds them.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, all sources at once in parallel,
and loaded with ``ctypes``. The libraries go to ``ops/_build/`` (listed in
``.gitignore``), named by a hash of their sources, so a second call in the
same checkout reuses them. Nothing is downloaded; a failed build raises.

There is no counterpart in ``safelife_tpu``: Pallas kernels compile
inside ``jax.jit``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int

#: source file -> {C entry point: its argument types}. Each entry point
#: launches one kernel form (the staged one, or the form for shapes too
#: large to stage whole: K1/K2 tiled, K3 windowed; its entry point ends in
#: ``_global``); each source also has
#: ``<first entry>_error``.
KERNELS = {
    "advance.cu": {
        "sl_advance": [_P] * 4 + [_I] * 9 + [_P],
        "sl_advance_global": [_P] * 4 + [_I] * 10 + [_P],
    },
    "physics.cu": {
        "sl_fused_actions_advance": [_P] * 8 + [_I] * 9 + [_P],
        "sl_fused_actions_advance_global": [_P] * 8 + [_I] * 10 + [_P],
    },
    "obs.cu": {
        "sl_recenter_views": [_P] * 7 + [_I] * 10 + [_P],
        "sl_recenter_views_global": [_P] * 7 + [_I] * 10 + [_P],
    },
}
_HEADERS = ("ca.cuh",)

#: Kernel launches by kernel form (the entry point without ``sl_``),
#: counted by :func:`launch` after each launch the runtime accepted.
LAUNCHES = {entry[3:]: 0 for entries in KERNELS.values() for entry in entries}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(source):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + _HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (source[:-3],
                                                  h.hexdigest()[:16]))


@functools.lru_cache(maxsize=None)
def kernels():
    """Compile (if needed) and load every kernel; returns a namespace of
    ctypes functions keyed by C entry point. Raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for source in KERNELS:
        lib = _library_path(source)
        if os.path.exists(lib):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    failures = []
    for source, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        with open(lib[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append("%s (exit %d):\n%s" % (source, proc.returncode,
                                                   log))
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))

    fns = {}
    for source, entries in KERNELS.items():
        lib = ctypes.CDLL(_library_path(source))
        err = getattr(lib, next(iter(entries)) + "_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[entry] = fn
            fns[entry + "_error"] = err
    return types.SimpleNamespace(**fns)


def build_logs():
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) of the libraries built in this checkout."""
    out = {}
    for source in KERNELS:
        path = _library_path(source)[:-3] + ".log"
        if os.path.exists(path):
            with open(path) as f:
                out[source] = f.read()
    return out


def launch(entry, device, *args):
    """Call a kernel's C entry point on ``device`` and PyTorch's current
    stream there, and count the launch in :data:`LAUNCHES`; raises if the
    launch was refused.

    The CUDA runtime launches on the calling thread's current device, so
    the call switches to ``device`` only when that is another one."""
    fn = getattr(kernels(), entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        code = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, stream)
    if code != 0:
        msg = getattr(kernels(), entry + "_error")(code).decode()
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (entry, code, msg))
    LAUNCHES[entry[3:]] += 1
