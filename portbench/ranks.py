"""A cell on several cards: one process (a rank) per card, started under
PyTorch's own launcher, and the few collectives the harness takes itself.

``python3 -m portbench.run`` (or ``portbench.control``) of a cell that asks
for more than one card runs itself again under ``torch.distributed.run
--standalone`` (:func:`launch`): one rank a card and a rendezvous on this
host.  Each rank reads ``RANK`` and ``WORLD_SIZE`` as the program's command
line does under ``torchrun`` and joins one process group (NCCL on the
cards, gloo on the CPU); rank 0 prints the result.  The launcher takes
that output only if the launch exits with 0; when a rank fails,
``torch.distributed.run`` ends the others and exits non-zero.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["Rank", "STARTED_ENV", "launch", "current", "started",
           "largest", "total", "agree", "replica_gap", "barrier", "leave"]

#: the launcher's start (``time.time()``), from which the ranks count their
#: set-up; set in the environment of a rank only
STARTED_ENV = "PORTBENCH_STARTED"


@dataclass
class Rank:
    index: int          # one host: also the index of the rank's card
    world: int


def current() -> Optional[Rank]:
    """The rank this process is (None in a launcher or a run on one
    card).  A rank but the first writes nothing to standard output, which
    the launcher reads."""
    if STARTED_ENV not in os.environ:
        return None
    rank = Rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
    if rank.index != 0:
        sys.stdout.flush()
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        os.close(devnull)
    return rank


def started() -> float:
    """The launcher's start on this process's ``time.perf_counter()``."""
    return time.perf_counter() - (time.time()
                                  - float(os.environ[STARTED_ENV]))


def launch(module: str, argv: List[str], world: int,
           started: float) -> Tuple[int, str]:
    """Run ``python3 -m <module> <argv>`` on *world* ranks and wait for
    all.  Returns the exit code and their standard output, which is empty
    unless every rank exited with 0.  *started*: the launcher's start
    (``time.time()``)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), "-m", module, *argv]
    proc = subprocess.Popen(cmd, env=dict(os.environ,
                                          **{STARTED_ENV: repr(started)}),
                            stdout=subprocess.PIPE, stdin=subprocess.DEVNULL)

    def stop(*_):
        raise SystemExit(1)
    previous = signal.signal(signal.SIGTERM, stop)
    try:
        out, _ = proc.communicate()
    finally:
        if proc.poll() is None:     # the launch ends its ranks itself
            proc.terminate()
            proc.wait()
        signal.signal(signal.SIGTERM, previous)
    if proc.returncode != 0:
        print(f"portbench: the launch of {world} ranks exited with "
              f"{proc.returncode}", file=sys.stderr, flush=True)
        return 1, ""
    return 0, out.decode()


# ---------------------------------------------------------------------------
# the harness's own collectives (the program's go through ``port``)
# ---------------------------------------------------------------------------

def _reduce(value: float, op, device) -> float:
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return float(t.item())


def largest(value: float, device) -> float:
    import torch.distributed as dist
    return _reduce(value, dist.ReduceOp.MAX, device)


def total(value: float, device) -> float:
    import torch.distributed as dist
    return _reduce(value, dist.ReduceOp.SUM, device)


def agree(n: int, device) -> int:
    """The largest of the ranks' *n*: every rank then runs as many
    steps, which the collectives inside a step need."""
    return int(largest(n, device))


def replica_gap(module) -> float:
    """The largest absolute difference between any rank's floating
    parameters and buffers and rank 0's: 0 where every rank holds the
    same model."""
    import torch
    import torch.distributed as dist
    with torch.no_grad():
        flat = torch.cat([t.detach().float().flatten()
                          for t in module.state_dict().values()
                          if t.is_floating_point()])
        first = flat.clone()
        dist.broadcast(first, src=0)
        gap = (flat - first).abs().max()
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap.item())


def barrier(device) -> None:
    import torch.distributed as dist
    dist.barrier()
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def leave() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
