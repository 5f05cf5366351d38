"""The comparisons that decide ``correct``: counts of elements that differ,
relative gaps of norms, and the worst leaf of a set of tensors."""

import numpy as np
import torch


def mismatches(prog, ref):
    """Elements of ``prog`` that differ from ``ref`` (any devices), or all
    of them where the shapes differ."""
    prog = torch.as_tensor(prog).to(ref.device)
    if prog.shape != ref.shape:
        return max(prog.numel(), ref.numel())
    return int((prog != ref).sum())


def rel(prog, ref):
    """The gap's norm over the reference's norm."""
    prog = torch.as_tensor(prog).to(ref.device).double()
    ref = ref.double()
    return (float(torch.linalg.vector_norm(prog - ref))
            / max(float(torch.linalg.vector_norm(ref)), 1e-30))


def norm(x):
    return float(torch.linalg.vector_norm(torch.as_tensor(x).double()))


def leaf_gaps(prog, ref, keep=None):
    """For each leaf of ``keep`` (all of ``ref``'s by default): the gap
    between the program's norm and the reference's, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keep = list(ref) if keep is None else list(keep)
    rn = {k: norm(ref[k]) for k in keep}
    med = float(np.median(list(rn.values())))
    return [abs(norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30)
            for k in keep]
