"""A stand-in rank for the launcher's tests: ends as a rank of
``python3 -m portbench.run`` ends (``run.finish``), rank 0 with a line
that names it.  The rank ``--fail`` names exits with 3 instead; the rank
``--load`` names first holds a stand-in module named ``flax``."""
import argparse
import sys
import types

from portbench import ranks, run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fail", type=int, default=-1)
    parser.add_argument("--load", type=int, default=-1)
    args = parser.parse_args()
    rank = ranks.current()
    if rank.index == args.fail:
        return 3
    if rank.index == args.load:
        sys.modules["flax"] = types.ModuleType("flax")
    print(f"rank {rank.index} of {rank.world} on standard output",
          flush=True)
    return run.finish({"rank": rank.index, "world": rank.world,
                       "compared": []} if rank.index == 0 else None)


if __name__ == "__main__":
    sys.exit(main())
