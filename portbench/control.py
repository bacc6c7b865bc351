"""Readings that set and prove the check's limits; the benchmark's runs
never run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--fault half_batch|no_exchange|local_stats|none] [--seconds 2]

Without ``--fault``: the control, the plain reference computed with the
operands of every product rounded to float8 e4m3 (the precision below the
cells' bf16) put in the program's place, against the float32 reference,
at the cell's own sizes.  With ``--fault``: a run of the cell with that
fault planted under the timed path (``portbench/faults.py``); with
``--fault none`` a sound run of the cell, for the program's readings on
many seeds in one process (one process a card, as ``portbench.run``
starts them, for a cell on several cards; the control needs one card).
Each seed prints one JSON line of the numbers the check compares, and
whether the cell's limits pass them.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()
STARTED_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import harness, port, ranks, session, spec  # noqa: E402
from portbench import traffic  # noqa: E402
from portbench import weights as weights_mod  # noqa: E402
from portbench.check import eval_numbers, judge, train_numbers  # noqa: E402
from portbench.reference.train import (eval_reference,  # noqa: E402
                                       metric_values, train_reference)


def leaves_of(cell, device):
    captured = {}

    def grab(leaves):
        captured["leaves"] = leaves
        raise StopIteration
    try:
        port.build(cell.config["tree"], cell.workload["metrics"], device, 0,
                   grab)
    except StopIteration:
        pass
    return captured["leaves"]


def control_numbers(cell, seed: int, device, leaves) -> dict:
    """The fp8 reference in the program's place against the float32
    reference, at the cell's sizes."""
    session._reference_mode()
    size, channels = session._image(cell)
    pool = traffic.make_pool(cell.traffic, size, channels, seed, device)
    tree = cell.config["tree"]
    arch = spec.load_arch(cell.config)
    w = weights_mod.make_weights(leaves, cell.config["weights"], seed,
                                 device)
    ckpt = device.type == "cuda"
    if cell.workload["entry"] == "eval_step":
        import numpy as np
        rng = np.random.default_rng(traffic.stream_seed(seed, 2))
        sample = sorted(int(i) for i in rng.choice(
            int(cell.traffic["pool"]), session.SAMPLED, replace=False))
        low = [eval_reference(arch, tree, w, pool[i], "fp8")
               for i in sample]
        ref = [eval_reference(arch, tree, w, pool[i]) for i in sample]
        own = [metric_values(lo["prediction"].cpu().numpy(),
                             pool[i]["mask"].cpu().numpy().astype(bool))
               for lo, i in zip(low, sample)]
        return eval_numbers(low, ref, own)
    lr, momentum = session._lr_momentum(tree)
    batches = pool[:session.CHECK_STEPS]
    low = train_reference(arch, tree, w, batches, seed, lr, momentum, "fp8",
                          ckpt=ckpt)
    ref = train_reference(arch, tree, w, batches, seed, lr, momentum,
                          ckpt=ckpt)
    return train_numbers(low, ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=2.0)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload)
    rank = ranks.current()
    if args.fault and cell.chips > 1 and rank is None:
        code, out = ranks.launch("portbench.control", argv, cell.chips,
                                 STARTED_EPOCH)
        sys.stdout.write(out)
        return code
    device = torch.device("cuda", rank.index if rank else 0) \
        if torch.cuda.is_available() else torch.device("cpu")
    leaves = None
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            planted = () if args.fault == "none" else (args.fault,)
            ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds,
                                  trace=False, device=device,
                                  started=time.perf_counter(),
                                  faults=planted, rank=rank)
            outcome = spec.load_module("entries",
                                       cell.workload["entry"]).run(ctx)
            if outcome is None:
                continue
            numbers = outcome.numbers
        else:
            leaves = leaves or leaves_of(cell, device)
            numbers = control_numbers(cell, seed, device, leaves)
        correct, _ = judge(numbers, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault or "control_fp8",
                          "correct": correct, "numbers": numbers}),
              flush=True)
    ranks.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
