"""The share of the profiled window in which no operation ran on the
device (the union of the device activities' spans against the window)."""


def read(t):
    p = t.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
