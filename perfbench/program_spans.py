"""The port's own layer spans in a profiled call.

The port opens a ``torch.profiler.record_function`` range at each layer
boundary while a profiler records (``safelife_tpu_torch/utils/trace.py``,
names with ``/``: ``ppo/rollout``, ``env/step``, ...). ``Profile.ranges``
keeps every host range by name, the CUDA runtime's calls among them, on
the clock of the device activities in ``Profile.device``. This module does
the interval arithmetic of the readers that read those spans:

* the union of a span's host ranges (those inside another span's ranges,
  when asked);
* the device's idle time inside it: the union intersected with the
  window less the union of the device activities;
* the runtime calls of some names whose host interval lies inside it.

A profile of a program without a span holds no range of its name: every
function here then returns an empty list or 0, and the readers nothing.
"""

import bisect

from .profiling import merge

#: Runtime calls that put work on the device's queue: a kernel, a copy, a
#: fill, a graph. A training iteration and an evaluation call on an H100
#: (torch 2.11, CUDA 12.8) made ``cudaLaunchKernel``,
#: ``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cudaMemcpyAsync`` and
#: ``cudaMemsetAsync`` of these, and ``cudaStreamSynchronize`` and
#: ``cudaDeviceSynchronize`` of :data:`BLOCKING`; the rest are their
#: variants. Their count there came within 0.5% of the device activities
#: of the same profile, the hand-written kernels' launches included.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaGraphLaunch")
#: Runtime calls that make the host wait for the device.
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


def inside(spans, merged):
    """The (start, end) of ``spans`` that lie inside one interval of the
    sorted disjoint ``merged``."""
    starts = [lo for lo, _ in merged]
    out = []
    for lo, hi in spans:
        i = bisect.bisect_right(starts, lo) - 1
        if i >= 0 and hi <= merged[i][1]:
            out.append((lo, hi))
    return out


def ranges(p, name, within=None):
    """The host ranges of span ``name``, sorted; with ``within``, those
    that lie inside a range of span ``within``."""
    spans = sorted(p.ranges.get(name, []))
    if within is not None:
        spans = inside(spans, merge(p.ranges.get(within, [])))
    return spans


def idle(p):
    """The window's intervals in which no device activity ran."""
    w0, w1 = p.window
    busy = merge((max(lo, w0), min(hi, w1)) for _, lo, hi in p.device
                 if hi > w0 and lo < w1)
    edges = [w0] + [x for lo, hi in busy for x in (lo, hi)] + [w1]
    return [[edges[i], edges[i + 1]] for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def overlap(a, b):
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def wait_us(p, name, within=None):
    """Microseconds of device idle inside the union of span ``name``'s
    ranges (those inside ``within``'s, when given)."""
    return overlap(merge(ranges(p, name, within)), idle(p))


def calls_inside(p, names, name):
    """How many runtime calls of ``names`` have a host interval inside a
    range of span ``name``, whatever thread made them."""
    merged = merge(p.ranges.get(name, []))
    return sum(len(inside(p.ranges.get(call, []), merged))
               for call in names)


def wait_ms_per(p, name, per, within=None):
    """Device idle ms inside span ``name`` over the count of span ``per``;
    ``None`` without a profile, or when either span is absent."""
    if p is None:
        return None
    n = len(p.ranges.get(per, []))
    if not n or name not in p.ranges:
        return None
    return 1e-3 * wait_us(p, name, within) / n


def calls_per(p, names, name, per):
    """Runtime calls of ``names`` inside span ``name`` over the count of
    span ``per``; ``None`` without a profile, or when either span is
    absent."""
    if p is None:
        return None
    n = len(p.ranges.get(per, []))
    if not n or name not in p.ranges:
        return None
    return calls_inside(p, names, name) / n
