"""The env step's share of its roofline: the least time the card could take
for one step's work (the larger of its bytes over HBM_BYTES_PER_S and its
int32 operations over INT32_OPS_PER_S, counted from the CA cells, the
agents and the views, ``perfbench.peaks``) over the device time of every
activity inside the step's ranges (``env.step_core`` and
``env._batch_obs``), however many kernels do the work."""


def read(t):
    if t.ranged is None or "step_bytes" not in t.work:
        return None
    per = t.ranged.device_in("env.step")[1:]
    n = t.cell.get("profile_steps")
    busy = sum(hi - lo for x in per for _, lo, hi in x) * 1e-6
    if not per or not n or busy <= 0:
        return None
    least, _ = t.peaks.bound(t.work["step_bytes"], t.work["step_ops"])
    return 100.0 * least / (busy / n)
