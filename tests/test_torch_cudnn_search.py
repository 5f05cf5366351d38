"""cuDNN's measured algorithm search (``models/nets.py::learner_precision``)
against its heuristic pick, on the card; skips without one. It imports
torch and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_cudnn_search.py

One PPO minibatch of 16,384 samples (the 4096-lane learner's) runs its
loss forward and ``backward()`` under the learner's context and, in
another process, under cuDNN's heuristic pick, both in strict float32:
cuDNN keeps the first plan a process runs at a shape, whichever way it was
chosen, so the two picks need a process each. They sum in other orders
only: the losses and each leaf's gradient agree to a tenth of the
benchmark's training limits (``loss_rel`` 2e-6, ``grad_leaf`` 1e-5), and
no convolution or dense layer runs with TF32 allowed. The worst leaf's
difference of gradients is bounded too, by 1e-4: on an H100 the measured
pick read 6.9e-6 of the heuristic's (grad_leaf 2.0e-7, the loss equal), and
the learner's TF32 mode, run as the control, 1.7e-2 (grad_leaf 2.3e-3).
"""

import os
import statistics
import subprocess
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

from safelife_tpu_torch.models import nets as TN  # noqa: E402
from safelife_tpu_torch.training import ppo as TP  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = 16384
VIEW = (25, 25)
#: A tenth of the benchmark's ``loss_rel`` and ``grad_leaf`` limits.
LOSS_REL = 2e-7
GRAD_LEAF = 1e-6
#: The worst leaf's difference of gradients (stricter than ``grad_leaf``,
#: which compares norms); the control has to read ten times more.
DIFFERENCE = 1e-4


class _HeuristicPolicy(torch.nn.Module):
    """``net``'s forward without its :func:`learner_precision`, so that the
    caller's cuDNN flags hold."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, obs):
        net = self.net
        x = torch.relu(net.dense(net.cnn(net.unpack(obs).to(torch.float32))))
        return net.value(x)[..., 0], torch.softmax(net.logits(x), dim=-1)


def _minibatch(dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = SAMPLES
    mb = {
        "obs": torch.randint(0, 2 ** 28, (n,) + VIEW, generator=g,
                             dtype=torch.int32),
        "actions": torch.randint(0, 9, (n,), generator=g),
        "action_prob": 0.05 + 0.95 * torch.rand(n, generator=g),
        "values": torch.randn(n, generator=g),
        "returns": torch.randn(n, generator=g),
        "advantages": torch.randn(n, generator=g),
        "weight": (torch.rand(n, generator=g) < 0.8).to(torch.float32),
    }
    return {k: v.to(dev) for k, v in mb.items()}


def _loss_and_grads(net, model, mb):
    """The minibatch's loss, {leaf: gradient} and, at every convolution and
    dense layer forward and backward, (TF32 allowed for cuBLAS or cuDNN,
    cuDNN's search on)."""
    seen = []

    def record(*_):
        seen.append((torch.backends.cuda.matmul.allow_tf32
                     or torch.backends.cudnn.allow_tf32,
                     torch.backends.cudnn.benchmark))

    hooks = []
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            hooks.append(m.register_forward_pre_hook(record))
            hooks.append(m.register_full_backward_pre_hook(record))
    try:
        with warnings.catch_warnings():
            # conv0's input needs no gradient: its hook fires on outputs.
            warnings.filterwarnings("ignore", message="Full backward hook")
            loss, _ = TP.calculate_loss(
                TP.PPOConfig(), model, mb["obs"], mb["actions"],
                mb["action_prob"], mb["values"], mb["returns"],
                mb["advantages"], mb["weight"])
            loss.backward()
    finally:
        for h in hooks:
            h.remove()
    return {"loss": loss.item(), "seen": seen,
            "grads": {k: p.grad.detach().cpu()
                      for k, p in net.named_parameters()}}


def run_pick(pick, out):
    """One side, in a fresh process: the seeded network and minibatch under
    ``pick`` ("measured": the learner's context; "heuristic": cuDNN's
    heuristic with TF32 off; "tensorfloat32": the learner's TF32 mode, the
    control), saved to ``out``."""
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    net = TN.SafeLifePolicyNetwork(
        view_shape=VIEW, unpack_channels=TN.TRAINING_CHANNELS, device=dev,
        precision="tensorfloat32" if pick == "tensorfloat32" else "float32")
    mb = _minibatch(dev)
    if pick == "heuristic":
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        allow_tf32=False):
            got = _loss_and_grads(net, _HeuristicPolicy(net), mb)
    else:
        with TN.learner_precision(net.precision, dev.type, SAMPLES):
            got = _loss_and_grads(net, net, mb)
    torch.save(got, out)


def _gaps(got, ref):
    """(loss gap over the reference's loss; by the worst leaf, the gap of
    the gradient's norms and the norm of the gradients' difference, each
    over the larger of the reference leaf's norm and the median leaf's).
    The second is the benchmark's ``grad_leaf``."""
    norms = {k: float(g.norm()) for k, g in ref["grads"].items()}
    median = statistics.median(norms.values())
    scale = {k: max(n, median) for k, n in norms.items()}
    return (abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            max(abs(float(got["grads"][k].norm()) - norms[k]) / scale[k]
                for k in norms),
            max(float((got["grads"][k] - ref["grads"][k]).norm()) / scale[k]
                for k in norms))


@pytest.mark.card
def test_measured_search_matches_heuristic_pick_in_strict_float32(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    got = {}
    for pick in ("measured", "heuristic", "tensorfloat32"):
        out = str(tmp_path / (pick + ".pt"))
        subprocess.run([sys.executable, os.path.abspath(__file__), pick, out],
                       check=True, cwd=ROOT, env=env, timeout=600)
        got[pick] = torch.load(out)
    # 6 layers forward and backward: TF32 allowed, the search on.
    assert got["measured"]["seen"] == [(False, True)] * 12
    assert got["heuristic"]["seen"] == [(False, False)] * 12
    assert got["tensorfloat32"]["seen"] == [(True, True)] * 12
    loss_rel, grad_leaf, diff = _gaps(got["measured"], got["heuristic"])
    control = _gaps(got["tensorfloat32"], got["heuristic"])
    print("measured: loss_rel %.3e, grad_leaf %.3e, difference %.3e; "
          "TF32: %.3e, %.3e, %.3e" % ((loss_rel, grad_leaf, diff) + control))
    assert loss_rel <= LOSS_REL
    assert grad_leaf <= GRAD_LEAF
    assert diff <= DIFFERENCE < control[2] / 10


if __name__ == "__main__":
    run_pick(sys.argv[1], sys.argv[2])
