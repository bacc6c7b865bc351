"""Faults planted under the timed path, for the tests and the readings
that show the check rejects them.  None is ever on in a benchmark run:
``python3 -m portbench.run`` has no way to ask for one.

* ``unchanged``: the optimizer step leaves the state as it was;
* ``half_batch``: the step sees the first half of each batch only, and
  its loss and gradient are the mean over that half;
* ``altered_answer``: the first image's probabilities come out flipped
  where the model produces them;
* ``no_exchange``: on several cards, each rank steps on its own slice's
  gradient (the step's gradient sum left out);
* ``local_stats``: on several cards, BatchNorm takes the statistics of
  the rank's own slice, not of the global batch.
"""
from __future__ import annotations

import contextlib
from typing import Iterable

import torch

from . import port

__all__ = ["FAULTS", "patched", "wrap_step"]

FAULTS = ("unchanged", "half_batch", "altered_answer", "no_exchange",
          "local_stats")


@contextlib.contextmanager
def patched(faults: Iterable[str], module=None):
    faults = set(faults)
    unknown = faults - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}")
    with contextlib.ExitStack() as stack:
        if "unchanged" in faults:
            saved = torch.optim.SGD.step
            torch.optim.SGD.step = lambda self, closure=None: None
            stack.callback(setattr, torch.optim.SGD, "step", saved)
        if "altered_answer" in faults and module is not None:
            def flip(_module, _args, out):
                out = out.clone()
                out[0] = 1 - out[0]
                return out
            stack.callback(module.register_forward_hook(flip).remove)
        if "no_exchange" in faults:
            stack.enter_context(port.no_exchange())
        if "local_stats" in faults:
            stack.enter_context(port.local_stats())
        yield


def wrap_step(faults: Iterable[str], step):
    if "half_batch" not in set(faults):
        return step

    def half(state, metrics_state, batch):
        cut = {k: v[:, :v.shape[1] // 2]
               if isinstance(v, torch.Tensor) and v.dim() > 1 else v
               for k, v in batch.items()}
        return step(state, metrics_state, cut)
    return half
