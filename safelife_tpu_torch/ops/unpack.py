"""K4: packed observation views -> the policy trunk's float32 input planes,
and their plain version.

Replaces no Pallas kernel: the JAX package leaves this unpack to XLA
(``safelife_tpu/models/nets.py::unpack_obs`` ``:74-81`` and the transpose
before the trunk, ``:94``). CUDA source ``csrc/unpack.cu``, which sets out
the bound (bytes) and the design.

``out[n, c, j, i] = float((views[n, i, j] >> channels[c]) & 1)``: int32
views [N, vh, vw] give float32 [N, C, vw, vh], contiguous NCHW, what the
trunk's first convolution takes: the JAX package's (h, w, c) -> (w, h, c)
swap, channels first.

The wrapper launches the kernel for CUDA tensors and runs
:func:`unpack_planes_plain` for CPU tensors; :mod:`._build` counts the
launches (``unpack_planes``). :func:`unpack_obs`, the channels-last unpack
the plain version permutes, is the port of the JAX package's.
"""

import ctypes
import functools

import torch

from . import _build
from .physics import MAX_SMEM_BYTES

#: Channels a call may take: the kernel's shifts are launch arguments.
MAX_CHANNELS = 32
#: Threads a block, which takes one sample: the fastest of 128 to 1024 at
#: 25, 4,096 and 16,384 samples of 25x25 views, or within 1% of it, and one
#: sample a block beat 2 to 16 (``chip_sweep.py unpack``, PERF.md § 6).
THREADS = 512
_INT32_MAX = 2 ** 31 - 1


def unpack_smem_bytes(vh, vw):
    """Shared bytes of a K4 block: the shifts and one sample's words
    (``csrc/unpack.cu::unpack_kernel``)."""
    return 4 * (MAX_CHANNELS + vh * vw)


@functools.lru_cache(maxsize=16)
def _shift_array(channels):
    return (ctypes.c_int * len(channels))(*channels)


def _check(views, channels):
    if views.dtype != torch.int32 or views.dim() != 3 \
            or not views.is_contiguous():
        raise ValueError("unpack_planes: expected contiguous int32 views "
                         "[N, vh, vw], got %s %s%s"
                         % (views.dtype, tuple(views.shape),
                            "" if views.is_contiguous()
                            else " (not contiguous)"))
    if not 1 <= len(channels) <= MAX_CHANNELS or \
            not all(0 <= c <= 31 for c in channels):
        raise ValueError("unpack_planes: 1 to %d channels, each a bit of "
                         "0 to 31, got %s" % (MAX_CHANNELS, channels))


def unpack_obs(obs, channels):
    """Packed int32 views [..., vh, vw] -> float32 [..., vh, vw, C]. The
    shift and mask run on the int32 word: bits above 24 do not survive a
    float32 cast."""
    shifts = torch.tensor(channels, dtype=torch.int32, device=obs.device)
    return ((obs[..., None] >> shifts) & 1).to(torch.float32)


def unpack_planes_plain(views, channels):
    """Plain version of K4: :func:`unpack_obs`, then the axes swapped to
    [N, C, vw, vh] and copied."""
    _check(views, channels)
    return unpack_obs(views, channels).permute(0, 3, 2, 1).contiguous()


def unpack_planes(views, channels):
    """The trunk's input planes of packed views.

    views int32 [N, vh, vw], contiguous; channels a tuple of 1 to 32 bit
    positions, each 0 to 31. Returns float32 [N, C, vw, vh], contiguous,
    each value 0 or 1.
    """
    channels = tuple(int(c) for c in channels)
    dev = views.device
    if dev.type == "cpu":
        return unpack_planes_plain(views, channels)
    _check(views, channels)
    if dev.type != "cuda":
        raise ValueError("unpack_planes: unsupported device %s" % dev)
    n, vh, vw = views.shape
    out = torch.empty((n, len(channels), vw, vh), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    if unpack_smem_bytes(vh, vw) > MAX_SMEM_BYTES:
        raise ValueError("unpack_planes: a %dx%d view needs %d bytes of "
                         "shared memory" % (vh, vw, unpack_smem_bytes(vh, vw)))
    if len(channels) * vh * vw > _INT32_MAX or n > _INT32_MAX:
        raise ValueError("unpack_planes: %d samples of %dx%d x %d channels "
                         "exceed 32-bit indexing" % (n, vh, vw, len(channels)))
    _build.launch("sl_unpack_planes", dev, views.data_ptr(), out.data_ptr(),
                  n, vh, vw, ctypes.addressof(_shift_array(channels)),
                  len(channels), THREADS)
    return out
