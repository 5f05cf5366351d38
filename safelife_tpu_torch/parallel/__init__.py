"""Multi-process training and the row-sharded board advance.

Port of ``safelife_tpu/parallel/``: :mod:`.mesh` (process groups, the lane
sharding of a training batch, the collectives the trainer and the level
pool use) and :mod:`.spatial` (one board split row-wise over the ranks,
with a one-row halo exchange a step).
"""
