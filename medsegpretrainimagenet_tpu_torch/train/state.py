"""Training state: the port of ``train/state.py``."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..parallel import device_count, rank

__all__ = ["TrainState"]


@dataclass
class TrainState:
    """Everything the train step threads through itself.

    ``module`` holds the parameters and the BatchNorm statistics,
    ``optimizer`` (a ``torch.optim`` optimizer over them) its moments.
    ``step`` counts optimizer steps and ``micro_step`` train-step calls,
    both host integers, so reading them costs no sync.  The random stream
    of a step (dropout, device augmentation) is derived from ``seed``,
    ``micro_step`` and the fragment's index, so resume reproduces it
    exactly, as ``step_rng`` does in the JAX package.
    """

    module: nn.Module
    optimizer: torch.optim.Optimizer
    seed: int
    step: int = 0
    micro_step: int = 0

    @classmethod
    def create(cls, module: nn.Module, optimizer: torch.optim.Optimizer,
               seed: int) -> "TrainState":
        return cls(module=module, optimizer=optimizer, seed=int(seed))

    def fragment_generator(self, fragment: int, device: torch.device,
                           sharded: bool = False) -> torch.Generator:
        """The generator of fragment *fragment* of the current step, on
        *device*: seeded from (seed, micro_step, fragment) on the host, and
        the process's rank when *sharded*, that is when this process holds
        its slice of the fragment (so the slices' dropout masks differ).
        A fragment replicated on every process (a ragged tail) draws the
        same masks everywhere, so the processes' updates stay equal."""
        entropy = [self.seed, self.micro_step, fragment]
        if sharded and device_count() > 1:
            entropy.append(rank())
        seed = np.random.SeedSequence(entropy).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(seed))
