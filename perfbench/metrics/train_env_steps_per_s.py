"""PPO training throughput: env steps (lanes x steps a lane) of every whole
``train_iteration`` of the window over the window's wall time, the clock
stopped after the device finished."""


def read(t):
    w = t.work
    return w["env_steps"] / w["seconds"] if "env_steps" in w else None
