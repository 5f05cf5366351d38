"""Tiny sizes of every cell, at which the CPU runs a whole cell in
seconds (the widths stay the published ones)."""

SIZES = {
    "ppo-append-spawn.train-4096": {"lanes": 2},
    "ppo-append-spawn.train-64": {"lanes": 1},
    "ppo-prune-spawn.eval-25": {
        "episodes": 3,
        "config": {"time_limit": 30, "side_effects": {"num_samples": 20}}},
    "ppo-prune-spawn.rollout-16384": {"lanes": 5, "judged": 3, "steps": 40,
                                     "profile_steps": 5},
}

#: The faults each cell's driver can plant.
FAULTS = {
    "train": ("unchanged", "half_batch", "token"),
    "evaluate": ("unchanged", "token"),
    "rollout": ("unchanged", "token"),
}

#: A seed above 32 signed bits: runs take any whole number that large.
SEED = 2 ** 31 + 104729
