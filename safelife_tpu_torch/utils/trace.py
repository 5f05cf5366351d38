"""Layer spans of the port, read by ``torch.profiler``.

``with span(name):`` marks a layer boundary. While a profiler records
(``torch.profiler.profile``, or ``torch.autograd.profiler.profile``) it
opens a ``torch.profiler.record_function`` range of that name, so the
profile holds the layer's host range on the clock of its device trace;
otherwise it costs one check and returns a shared object that does
nothing. There is no switch of its own: a run is traced when a profiler
is around it. Spans nest on the calling thread, so each span of an
iteration or a call lies inside that iteration's or call's top span.

Names take ``/``. The spans, where they are opened
(``safelife_tpu_torch/...``) and how often:

* ``ppo/iteration``: ``training/ppo.py::train_iteration``; an iteration.
* ``ppo/rollout``: ``ppo.py::rollout``, the final values' forward
  included; an iteration.
* ``policy/sample``: the policy's forward, the sampling and the taken
  probability's gather in ``ppo.py::rollout``, and
  ``training/runner.py::_policy_sample``; a step.
* ``env/step``: ``env/wrappers.py::step``; a training step.
* ``env/core``: ``env/env.py::step_core``; a step.
* ``env/obs``: ``env/env.py::_batch_obs``; a step and a reset.
* ``ppo/gae``: ``compute_gae``, ``flatten_batch`` and ``sample_shard`` in
  ``train_iteration``; an iteration.
* ``ppo/update``: ``ppo.py::train_on_batch``; an iteration.
* ``ppo/minibatch``: one minibatch of ``train_on_batch`` (the gather, the
  loss, the backward and the Adam step); ``epochs_per_batch x
  (num_minibatches + 1)`` an iteration.
* ``ppo/metrics``: ``_batch_loss`` and the weighted sums after the update
  in ``train_iteration``; an iteration.
* ``rollout/episodes``: ``training/runner.py::run_episodes``; a call.
* ``eval/benchmark``: ``runner.py::benchmark``; a call.
* ``eval/batch``: one batch of lanes in ``benchmark``; a batch.
* ``side_effects/occupancy``: ``side_effects.py::batched_occupancy``; a
  batch.
* ``eval/readback``: ``benchmark``'s copies to the host, where the host
  waits for the device; a batch.
* ``side_effects/emd``: ``side_effects.py::episode_side_effects``; an
  episode.
* ``side_effects/emd_exact``: the native network simplex in
  ``side_effects.py::emd_hat``; a cell type whose distributions differ in
  at most ``EXACT_EMD_MAX_CELLS`` cells.
* ``side_effects/emd_sinkhorn``: the Sinkhorn solve in ``emd_hat``; a
  cell type whose distributions differ in more.
* ``eval/records``: ``benchmark``'s records and
  ``data_logger.log_episode``; a batch.
* ``dqn/unit``: ``training/dqn.py::collect_and_optimize``; a unit.
* ``dqn/collect``: ``dqn.py::collect`` (the ε-greedy forwards, the
  wrapped steps, the n-step rings and the push); a unit.
* ``dqn/push``: ``dqn.py::push_emissions``, inside ``dqn/collect``; a
  unit.
* ``dqn/optimize``: ``dqn.py::optimize`` (the replay gather, the TD loss
  with the target network's forward, the backward, the Adam step and the
  target sync); a unit.

To see them, run any profiler around a training iteration or a
benchmark call and read its events or ``key_averages()`` by name.
"""

import torch

#: Every span name the port opens (the list above).
SPANS = (
    "ppo/iteration", "ppo/rollout", "policy/sample", "env/step", "env/core",
    "env/obs", "ppo/gae", "ppo/update", "ppo/minibatch", "ppo/metrics",
    "rollout/episodes", "eval/benchmark", "eval/batch",
    "side_effects/occupancy", "eval/readback", "side_effects/emd",
    "side_effects/emd_exact", "side_effects/emd_sinkhorn", "eval/records",
    "dqn/unit", "dqn/collect", "dqn/push", "dqn/optimize",
)

_recording = torch._C._autograd._profiler_enabled


class _Off:
    """The span of an unprofiled run: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """A context manager around one layer's work: a ``record_function``
    range named ``name`` while a profiler records, else a no-op."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)
