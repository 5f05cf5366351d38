"""The whole training step's share of the card's float32 peak: the model
FLOPs of an iteration counted from the network's shapes
(``perfbench.peaks.ppo_iteration_flops``) times the traced window's
iterations, over the window's wall time (outside the profiler) and
``FP32_FLOPS_PER_S`` (67 TFLOP/s, the data sheet's float32 rate without
tensor cores at 700 W)."""


def read(t):
    w = t.work
    if not w.get("iterations") or "flops_per_iteration" not in w:
        return None
    rate = w["flops_per_iteration"] * w["iterations"] / w["seconds"]
    return 100.0 * rate / t.peaks.FP32_FLOPS_PER_S
