"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number the check compared with
its limit); the compared numbers are also the last lines of standard
error.  Without as many CUDA cards as the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it exits non-zero and
prints no result.  A cell on several cards runs this command once per
card under ``torch.distributed.run`` (``portbench/ranks.py``): every
rank and the launcher make the check of their modules, and the launcher
prints rank 0's line.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()
STARTED_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from portbench import ranks  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def note(what: str) -> None:
    print(f"portbench: {what} at {time.perf_counter() - STARTED:.3f} s",
          file=sys.stderr, flush=True)


def fail(message: str) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    from portbench import harness, spec

    bench = spec.load_benchmark()
    cell = spec.load_cell(args.workload)
    import torch

    note("torch imported")
    if not torch.cuda.is_available():
        return fail("no CUDA card: the benchmark measures the card")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} found")
    note("cards found")
    rank = ranks.current()
    if cell.chips > 1 and rank is None:
        code, out = ranks.launch("portbench.run", argv, cell.chips,
                                 STARTED_EPOCH)
        return code or finish(json.loads(out.splitlines()[-1]))
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace),
                          device=torch.device("cuda", rank.index if rank
                                              else 0),
                          started=ranks.started() if rank else STARTED,
                          rank=rank)
    line = harness.run_cell(ctx, bench)
    ranks.leave()
    return finish(line)


def finish(line) -> int:
    """The end of a run, on every rank and in a launcher: exit 1 if JAX or
    the JAX package is loaded; else print *line* (None on a rank but the
    first), the compared numbers last on standard error."""
    from portbench import harness
    loaded = harness.forbidden_modules()
    if loaded:
        return fail(f"loaded in this process: {', '.join(loaded)}")
    if line is None:
        return 0
    for name, value, limit in line["compared"]:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
