"""The yardstick's arithmetic: the card's peaks, the work of an env step
counted from its shapes, and the policy network's FLOPs.

The integer rates and the per-cell, per-agent and per-view operation
counts are the rules the port's kernel table has used since its first
kernel (``chip_smoke.py::bound``, ``view_work``, ``covered_cells``),
frozen here so that no later change to the program moves them.
"""

import torch

#: One H100 SXM (data sheet): device memory at 3.35 TB/s; 32-bit integer
#: add, shift, logic and compare at 64 an SM a clock (CUDA C++ Programming
#: Guide, compute capability 9.0) x 132 SMs x 1.98 GHz boost; float32
#: outside the tensor cores at 67 TFLOP/s, the rate of the configurations'
#: strict float32 (TF32 off).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_FLOPS_PER_S = 67e12

#: Integer operations of one cell of one CA step in the separable form
#: (pack 20, neighbourhood sum and OR 8, rule 27), and of one agent's
#: action.
CA_OPS_PER_CELL = 55
ACTION_OPS_PER_AGENT = 60
#: Operations of one view element (wrap, pack), and of one exit of one
#: view (its projection onto the view).
VIEW_OPS_PER_ELEMENT = 10
EXIT_OPS_PER_VIEW = 12


def bound(nbytes, nops):
    """(seconds, "bytes" or "operations"): the larger of the time to move
    the bytes and the time to issue the integer operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def covered_cells(h, w, cy, cx, exit_locs, exit_valid, view):
    """Board cells that the views and the valid exits of all lanes cover,
    summed over lanes: what the views must read of the boards, and as much
    of the goals."""
    b = cy.shape[0]
    vh, vw = view
    dev = cy.device
    rows = (cy[..., None] - vh // 2 + torch.arange(vh, device=dev)) % h
    cols = (cx[..., None] - vw // 2 + torch.arange(vw, device=dev)) % w
    idx = (rows[..., :, None] * w + cols[..., None, :]).reshape(b, -1)
    hit = torch.zeros((b, h * w), dtype=torch.int32, device=dev)
    hit.scatter_(1, idx.long(), 1)
    hit.scatter_reduce_(1, (exit_locs[..., 0] * w + exit_locs[..., 1]).long(),
                        exit_valid.to(torch.int32), "amax")
    return int(hit.sum())


def view_work(h, w, cy, cx, exit_locs, exit_valid, view):
    """(bytes, int32 operations) of the packed views on these inputs: the
    covered board and goal words read once, the centres, exits and their
    flags read, each view word written once."""
    b, a = cy.shape
    e = exit_locs.shape[1]
    vh, vw = view
    nbytes = (2 * covered_cells(h, w, cy, cx, exit_locs, exit_valid, view) * 4
              + 2 * b * a * 4 + b * e * 9 + b * a * vh * vw * 4)
    return nbytes, b * a * (vh * vw * VIEW_OPS_PER_ELEMENT
                            + e * EXIT_OPS_PER_VIEW)


def board_step_work(b, h, w, a):
    """(bytes, operations) of the agents' actions and one CA step of b
    boards: each board read and written once, the agents' locations read
    and written, their actions and cells, the spawn probabilities and the
    seed."""
    hw = h * w
    return (2 * b * hw * 4 + b * a * (2 * 2 * 4 + 4 + 4) + b * 4 + 8,
            b * hw * CA_OPS_PER_CELL + b * a * ACTION_OPS_PER_AGENT)


def goals_step_work(b, h, w):
    """(bytes, operations) of one CA step of b goal boards."""
    hw = h * w
    return 2 * b * hw * 4 + b * 4 + 8, b * hw * CA_OPS_PER_CELL


def conv_out(n, kernel, stride):
    return (n - kernel) // stride + 1


def policy_macs(net, view):
    """(multiply-adds of one sample's forward, those of the first
    convolution) of the policy network ``net`` (a configuration's
    ``policy``) on views of ``view``."""
    h, w = view
    c = len(net["channels"])
    total = first = 0
    for i, layer in enumerate(net["convs"]):
        k, s = layer["kernel"], layer["stride"]
        h, w = conv_out(h, k, s), conv_out(w, k, s)
        macs = h * w * layer["out"] * k * k * c
        c = layer["out"]
        total += macs
        if i == 0:
            first = macs
    hidden = net["dense"]["out"]
    total += h * w * c * hidden + hidden * (1 + net["actions"])
    return total, first


def ppo_iteration_flops(net, view, samples, epochs):
    """FLOPs of one PPO iteration over ``samples`` learner samples (steps x
    lanes x agents): the rollout's forwards (each step's and the final
    values', ``samples`` + samples / steps, given here as
    ``samples["rollout"]``), forward and backward of every minibatch of
    every epoch (the backward twice the forward, the first convolution
    without an input gradient) and the forward of the post-update loss.
    ``samples``: {"rollout": n, "batch": n}."""
    macs, first = policy_macs(net, view)
    fwd = 2 * macs
    fwd_bwd = fwd + 2 * fwd - 2 * first
    return (samples["rollout"] * fwd + epochs * samples["batch"] * fwd_bwd
            + samples["batch"] * fwd)
