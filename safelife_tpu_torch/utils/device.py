"""Device resolution for the port's entry points.

The card is the default: an entry point takes ``device="cuda"`` unless the
caller asks for ``"cpu"``, and never carries on on the CPU when no card is
there (there is no counterpart in ``safelife_tpu``, where JAX picks the
backend).
"""

import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % str(device))
    return dev


def require_device(device, actual, what):
    """Raises unless ``actual`` (the ``torch.device`` that ``what`` lives
    on) is ``resolve_device(device)``."""
    dev = resolve_device(device)
    if actual.type != dev.type or dev.index not in (None, actual.index):
        raise ValueError("%s lives on %s, not on the requested %s"
                         % (what, actual, dev))
