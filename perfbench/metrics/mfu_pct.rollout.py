"""The whole rollout step's share of the card's float32 peak: the policy's
forward FLOPs of every step of the traced window (one forward of every
lane's agents a step, counted from the network's shapes,
``perfbench.peaks.policy_macs``) over the window's wall time (outside the
profiler) and ``FP32_FLOPS_PER_S`` (67 TFLOP/s). The env step's integer
work is the kernels' roofline's, not this."""


def read(t):
    w = t.work
    if not w.get("seconds") or "policy_flops" not in w:
        return None
    return 100.0 * w["policy_flops"] / w["seconds"] / t.peaks.FP32_FLOPS_PER_S
