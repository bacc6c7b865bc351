"""Small cells for the CPU tests: the benchmark's own cells with the
configurations cut, by their architecture modules, to a few channels and
32 x 32 images."""
from __future__ import annotations

import copy

from portbench import spec


def small_cell(name: str, batch: int = 4, compute_dtype: str = "float32"):
    """The cell *name* at a size the CPU runs in a second or two: its
    architecture's own cut (``small``)."""
    cell = copy.deepcopy(spec.load_cell(name))
    cell.config["tree"] = spec.load_arch(cell.config).small(
        cell.config["tree"])
    cell.config["image_size"] = 32
    cell.traffic.update(batch=batch, pool=4)
    cell.workload["compute_dtype"] = compute_dtype
    return cell


def data_parallel_cell(world: int = 2, batch: int = 8):
    """The U-Net training cell on *world* cards at a small size: the
    one-card cell's step, loss, traffic and limits with a global batch of
    *batch* (each rank's slice a part of it by mask area), and
    ``replicas`` (every rank's model against rank 0's) held to 0."""
    cell = small_cell("unet_256.train_b32", batch=batch)
    cell.name = f"unet_256.train_dp{world}_b{batch}"
    cell.chips = cell.workload["chips"] = world
    cell.limits["replicas"] = 0.0
    return cell


def _rank_main(index, world, port, cell, seed, faults, trace, out):
    """One gloo rank of :func:`run_ranks` (a spawned process), with the
    environment ``torch.distributed.run`` gives a rank."""
    import os
    import time

    import torch

    from portbench import harness, ranks

    os.environ.update(RANK=str(index), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(index), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.2, trace=trace,
                          device=torch.device("cpu"),
                          started=time.perf_counter(), faults=faults,
                          rank=ranks.Rank(index, world))
    line = harness.run_cell(ctx, spec.load_benchmark())
    ranks.leave()
    if line is not None:
        out.put(line)


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(cell, world: int = 2, seed: int = 2 ** 31 + 11, faults=(),
              trace: bool = False) -> dict:
    """Rank 0's result line of a run of *cell* on *world* gloo ranks on the
    CPU, each a process of its own, as a cell on several cards runs."""
    import torch.multiprocessing as mp

    context = mp.get_context("spawn")
    out = context.SimpleQueue()
    mp.start_processes(_rank_main, args=(world, _free_port(), cell, seed,
                                         tuple(faults), trace, out),
                       nprocs=world, join=True, start_method="spawn")
    return out.get()
