"""The benchmark's harness: one run of one cell.

A run reads its cell from ``BENCHMARK.json`` and the files named after it:
the workload ``perfbench/workloads/<cell>.json`` (its driver, its sizes,
its limits), the configuration file that ``BENCHMARK.json`` names, the
driver ``perfbench/drivers/<driver>.py`` and each metric's reader
``perfbench/metrics/<metric>.py``. It sets the program up (the driver's
``setup``: build, load, warm up every shape), measures the window (the
driver's ``window``), reads the device's memory peak, profiles a short
window when traced, then judges the outputs against the plain reference
(the driver's ``check``) and returns the result line.

A driver module has ``setup(ctx)``, ``window(run, seconds)`` -> work,
``spans(run)`` -> [(module, attribute, span name, sync)],
``profiled(run)`` (one short steady call for the profiler; optional
``ranged(run)`` -> [(module, attribute, range name)] for a second profile
whose ranges wait for the device at both ends), ``check(run)`` ->
{number: value} and ``FAULTS`` {name: ctx -> context manager}.
"""

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
import types
import zlib

import numpy as np
import torch

from . import peaks, program
from .capture import Spans
from .profiling import Profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Top-level module names that may not be loaded in a run: JAX and the JAX
#: package, of which the port is a port.
FORBIDDEN = ("jax", "jaxlib", "flax", "safelife_tpu")


def process_start():
    """This process's start on the clock of ``time.CLOCK_BOOTTIME``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.clock_gettime(time.CLOCK_BOOTTIME)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``safelife_tpu_torch`` is not ``safelife_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name, root=ROOT):
    """(BENCHMARK.json, its workload entry, the workload file, the
    configuration file) of cell ``name``."""
    bench = manifest(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError("no workload %r in BENCHMARK.json (%s)"
                       % (name, ", ".join(sorted(entries))))
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    wl = load_json(os.path.join(root, "perfbench", "workloads",
                                name + ".json"))
    cfg = load_json(os.path.join(root, *configs[entry["config"]]["file"]
                                 .split("/")))
    return bench, entry, wl, cfg


def driver(name, root=ROOT):
    return load_file(os.path.join(root, "perfbench", "drivers", name + ".py"),
                     "perfbench_driver_" + name.replace("-", "_"))


def metric_reader(name, root=ROOT):
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    return load_file(path, "perfbench_metric_" + name.replace(".", "_")
                     .replace("-", "_"))


def applies(metric, workload, bench):
    """Whether ``metric`` (an entry of BENCHMARK.json) is reported in
    ``workload``: its ``workloads`` list, else every cell that reports
    the end-to-end metric it moves (an end-to-end metric without the key:
    every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        return applies(e2e[metric["moves"]], workload, bench)
    return True


class Context:
    """What a driver gets: the cell, its seed, the device and the port."""

    def __init__(self, root, name, seed, device, wl, cfg, control=False,
                 fault=None, started=None):
        self.root, self.name, self.seed = root, name, int(seed)
        self.started = started
        self.phases = []
        self.device = torch.device(device)
        self.wl, self.cfg = wl, cfg
        self.control, self.fault = control, fault
        self.port = program.port(root)

    def seed_for(self, tag):
        """A 63-bit seed for ``tag`` drawn from the run's seed."""
        ss = np.random.SeedSequence(self.seed,
                                    spawn_key=(zlib.crc32(tag.encode()),))
        hi, lo = (int(x) for x in ss.generate_state(2, np.uint32))
        return ((hi << 32) | lo) & (2 ** 63 - 1)

    def rng(self, tag):
        return np.random.default_rng(self.seed_for(tag))

    def phase(self, name):
        """Mark the end of a set-up phase (seconds since the start)."""
        self.sync()
        self.phases.append([name, time.clock_gettime(time.CLOCK_BOOTTIME)
                            - self.started])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run(name, seed, seconds, trace=False, device="cuda", root=ROOT,
        control=False, fault=None, sizes=None, started=None):
    """One run of cell ``name``. Returns (result line dict, checks
    {number: {"value", "limit"}}); ``sizes`` overrides the workload's
    parameters, and its ``config`` entry the configuration's (tests run
    tiny cells on the CPU with it)."""
    started = process_start() if started is None else started
    bench, entry, wl, cfg = cell(name, root)
    sizes = dict(sizes or {})
    cfg = dict(cfg, **sizes.pop("config", {}))
    wl = dict(wl, **sizes)
    drv = driver(wl["driver"], root)
    ctx = Context(root, name, seed, device, wl, cfg, control, fault, started)
    ctx.phase("imports and the port")
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    faults = drv.FAULTS.get(fault) if fault else None
    if fault and faults is None:
        raise KeyError("driver %s has no fault %r" % (wl["driver"], fault))

    with (faults(ctx) if faults else contextlib.nullcontext()):
        state = drv.setup(ctx)
        ctx.phase("set-up")
        setup_s = ctx.phases[-1][1]
        spans = None
        if trace:
            spans = Spans()
            for module, attr, span, sync in drv.spans(state):
                spans.wrap(module, attr, span, sync)
        try:
            work = drv.window(state, seconds)
        finally:
            if spans is not None:
                spans.close()
        ctx.sync()
        peak = (torch.cuda.max_memory_allocated(ctx.device)
                if ctx.device.type == "cuda" else 0)
        prof = ranged = None
        if trace and ctx.device.type == "cuda":
            prof = _profile(state, drv, getattr(drv, "ranges", None), False)
            if hasattr(drv, "ranged"):
                ranged = _profile(state, drv, drv.ranged, True)
    t0 = time.perf_counter()
    checks = drv.check(state)
    reference_s = time.perf_counter() - t0
    del state
    gc.collect()

    t = types.SimpleNamespace(
        setup_s=setup_s, work=work, cell=wl, config=cfg, peaks=peaks,
        spans=spans.seconds if spans else {}, profile=prof, ranged=ranged)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if not applies(m, name, bench):
            continue
        value = metric_reader(m["name"], root).read(t)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = wl["limits"]
    missing = set(limits) ^ set(checks)
    if missing:
        raise RuntimeError("checks and limits differ in %s" % sorted(missing))
    judged = {k: {"value": float(checks[k]), "limit": float(limits[k])}
              for k in limits}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in judged.values())
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(work["attempted"]),
              "failed": int(work.get("failed", 0)), "metrics": metrics,
              "device": dev}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown()
    result["setup_phases"] = ctx.phases
    result["reference_s"] = reference_s
    result["checks"] = judged
    return result, judged


def _profile(state, drv, points, sync):
    spans = Spans(sync=sync, ranges=True)
    for module, attr, name in (points(state) if points else []):
        spans.wrap(module, attr, name)
    try:
        return Profile(lambda: drv.profiled(state))
    finally:
        spans.close()
