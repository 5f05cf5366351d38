"""A profiled window: what ran on the device, when, and what the host was
doing while it idled (``torch.profiler``, CUPTI on the card)."""

import bisect
import time

import torch

WINDOW = "perfbench.window"
NO_OP = "host Python (no profiled operation)"


def merge(spans):
    """The union of (start, end) spans, as sorted disjoint [start, end]."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def idle_by_host(merged, host, window):
    """{host operation: idle seconds}: the window's time outside the
    ``merged`` device spans (us), each gap named by the innermost of the
    ``host`` operations (sorted (start, end, name), nesting on one thread)
    open at its middle."""
    w0, w1 = window
    edges = [w0] + [x for lo, hi in merged for x in (lo, hi)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out, stack, i = {}, [], 0
    for lo, hi in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (lo + hi)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else NO_OP
        out[name] = out.get(name, 0.0) + (hi - lo) * 1e-6
    return out


class Profile:
    """One profiled call of ``fn``.

    ``window_s``: its length on the profiler's clock; ``device``: (name,
    start us, end us) of every device activity; ``busy_s``: the union of
    their spans; ``ranges``: {range name: [(start us, end us)]} of the
    ``record_function`` ranges on the host; ``gaps``: {what the host was
    doing: idle seconds} over the window's device idle time."""

    def __init__(self, fn):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = prof.events()
        self.device, host, window = [], [], None
        for e in events:
            lo, hi = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # A user annotation spans the device work it launched, gaps
                # included: not an activity of its own.
                if not getattr(e, "is_user_annotation", False):
                    self.device.append((e.key, lo, hi))
            elif e.name == WINDOW:
                window = (lo, hi, e.thread)
            else:
                host.append((lo, hi, e.name, e.thread))
        if window is None:
            raise RuntimeError("the profile holds no window range")
        self.window = window[:2]
        self.window_s = (window[1] - window[0]) * 1e-6
        self.device.sort(key=lambda d: d[1])
        self.ranges = {}
        for lo, hi, name, _ in host:
            self.ranges.setdefault(name, []).append((lo, hi))
        merged = merge((lo, hi) for _, lo, hi in self.device)
        self.busy_s = sum(hi - lo for lo, hi in merged) * 1e-6
        main = sorted((lo, hi, name) for lo, hi, name, thread in host
                      if thread == window[2])
        self.gaps = idle_by_host(merged, main, self.window)
        self.read_s = time.perf_counter() - t0

    def device_in(self, name):
        """The device activities that start and end inside the host ranges
        ``name`` (ranges that wait for the device at both ends), per
        range: [[(activity, start, end), ...], ...]."""
        out = []
        starts = [d[1] for d in self.device]
        for lo, hi in sorted(self.ranges.get(name, [])):
            j = bisect.bisect_left(starts, lo)
            inside = []
            while j < len(self.device) and self.device[j][1] <= hi:
                if self.device[j][2] <= hi:
                    inside.append(self.device[j])
                j += 1
            out.append(inside)
        return out

    def breakdown(self, top=10):
        ops = {}
        for name, lo, hi in self.device:
            ops[name] = ops.get(name, 0.0) + (hi - lo) * 1e-6
        rank = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in rank],
                "idle_gaps": [[k, v] for k, v in gaps]}
