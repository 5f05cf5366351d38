"""Device activities a rollout step's env step runs (``env.step_core`` and
the views of ``env._batch_obs``), from a profile whose ranges wait for the
device at both ends; the views of the reset before the first step are
left out."""


def steps(t):
    if t.ranged is None:
        return None
    per = t.ranged.device_in("env.step")[1:]
    return per if per else None


def read(t):
    per = steps(t)
    n = t.cell.get("profile_steps")
    return None if per is None or not n else sum(len(x) for x in per) / n
