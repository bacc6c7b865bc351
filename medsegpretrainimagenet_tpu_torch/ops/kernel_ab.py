"""Time this tree's K1 and K2 against another checkout's, on the card, in turns.

    python -m medsegpretrainimagenet_tpu_torch.ops.kernel_ab OTHER_CHECKOUT

Each tree's kernels are built from its own ``csrc/`` and called through its
own wrappers (``window_attention_cuda``, ``image_attention_cuda``) in a
process that imports only that tree's package, so the two trees' C
interfaces need not agree.  The processes run in turns, other, this, this,
other; each times bf16 K1 and K2 at the seven level shapes of
``swin_unet_224`` at batch 24, L2-cold (:func:`device_ms` over
:func:`input_copies`), on the same inputs made from one seed.  The first
turn of each tree also saves its outputs under ``build/kernel_ab/``, and the
two trees' outputs must agree within the bf16 bar.  Prints the card's name
and power limit, ``[ab]`` lines per shape, the sums per forward, and exits
non-zero on any failure.

The timing helpers here are also ``chip_smoke.py``'s.  Nothing runs at
import, and the module imports nothing of the package: a worker imports
the package of the tree it times.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Optional

#: the H100's L2
L2_BYTES = 50 * 2 ** 20

#: attention shapes of swin_unet_224 at batch 24: (level, heads, windows
#: per image, masked calls per forward, unmasked calls per forward)
BATCH = 24
LEVELS = [(0, 3, 64, 2, 2), (1, 6, 16, 2, 2), (2, 12, 4, 2, 2),
          (3, 24, 1, 0, 2)]
TOKENS, HEAD_DIM, WINDOW = 49, 32, 7
BF16_TOL = 0.05

THIS = Path(__file__).resolve().parents[2]


def hold_stream(calls: int) -> None:
    """Hold the current stream with a spin kernel long enough (about 0.2
    ms a call) for the host to queue *calls* calls behind it, so that the
    events around them time the device and not the host's launch rate: a
    small kernel runs faster than Python can launch it."""
    import torch

    torch.cuda._sleep(400_000 * calls)


def input_copies(*tensors) -> list:
    """*tensors* and as many clones as make all of them together exceed
    twice the card's L2, for :func:`device_ms`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(2 * L2_BYTES // nbytes)]


def device_ms(fn, copies: list, runs: int = 3) -> float:
    """Device time of ``fn(*inputs)`` per call: the mean over back-to-back
    calls that rotate over *copies* of the inputs, from CUDA events around
    them, and the median of *runs* such runs.  With one copy the inputs
    stay in the L2 where they fit (warm); with :func:`input_copies` each
    call finds its inputs evicted by the calls before it (L2-cold), as a
    layer of the model finds its activations.  A host stall longer than
    :func:`hold_stream` covers leaves a gap inside one run; the median
    drops that run."""
    import torch

    for i in range(max(3, len(copies))):
        fn(*copies[i % len(copies)])
    iters = max(20, 2 * len(copies))
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        hold_stream(iters)
        start.record()
        for i in range(iters):
            fn(*copies[i % len(copies)])
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def _shapes():
    """(name, level, heads, windows per image, masked, calls per forward)"""
    for level, heads, n_w, n_masked, n_plain in LEVELS:
        for masked, calls in ((False, n_plain), (True, n_masked)):
            if calls:
                yield (f"level {level} {'SW-MSA' if masked else 'W-MSA '}",
                       level, heads, n_w, masked, calls)


def _worker(tree: Path, save: Optional[Path]) -> None:
    """Time *tree*'s kernels at every shape; print ``{shape: ms}`` as JSON
    and, with *save*, write the outputs there."""
    sys.path[0] = str(tree)  # the tree's package, not the one beside us
    import torch

    from medsegpretrainimagenet_tpu_torch.models.swin import _shift_attn_mask
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    if not Path(wa.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {wa.__file__}, not {tree}'s package")
    gen = torch.Generator().manual_seed(4)
    scale = HEAD_DIM ** -0.5
    times, outs = {}, {}
    for shape, level, heads, n_w, masked, _ in _shapes():
        res = 56 // 2 ** level
        q, k, v = (torch.randn(BATCH * n_w, heads, TOKENS, HEAD_DIM,
                               generator=gen).to("cuda", torch.bfloat16)
                   for _ in range(3))
        qkv = torch.randn(BATCH, res, res, 3 * heads * HEAD_DIM,
                          generator=gen).to("cuda", torch.bfloat16)
        bias = (0.02 * torch.randn(heads, TOKENS, TOKENS,
                                   generator=gen)).cuda()
        mask = torch.from_numpy(_shift_attn_mask(
            (res, res), WINDOW, WINDOW // 2)).cuda() if masked else None

        def k1(q, k, v):
            return wa.window_attention_cuda(q, k, v, bias, mask, scale)

        def k2(qkv):
            return wa.image_attention_cuda(qkv, bias, mask, scale, WINDOW)

        for name, fn, inputs in (("k1", k1, (q, k, v)), ("k2", k2, (qkv,))):
            if save is not None:
                outs[f"{name} {shape}"] = fn(*inputs).cpu()
            copies = input_copies(*inputs)
            times[f"{name} {shape}"] = device_ms(fn, copies)
            del copies
    if save is not None:
        torch.save(outs, save)
    print(json.dumps(times), flush=True)


def _turn(tree: Path, save: Optional[Path]) -> dict:
    cmd = [sys.executable, __file__, "--worker", str(tree)]
    if save is not None:
        cmd += ["--save", str(save)]
    run = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                         timeout=900)
    if run.returncode != 0:
        sys.exit(f"kernel_ab: the turn of {tree} failed:\n{run.stderr}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, nargs="?",
                        help="another checkout of the repo, e.g. a git "
                             "archive of the parent commit")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker.resolve(), args.save)
        return 0
    if args.other is None:
        parser.error("the other checkout is missing")
    import torch

    other = args.other.resolve()
    if not (other / "medsegpretrainimagenet_tpu_torch").is_dir():
        sys.exit(f"kernel_ab: {other} holds no medsegpretrainimagenet_tpu_"
                 f"torch package")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    out_dir = THIS / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    times = {"other": [], "this": []}
    for who, tree in (("other", other), ("this", THIS), ("this", THIS),
                      ("other", other)):
        first = not times[who]
        times[who].append(_turn(tree, out_dir / f"{who}.pt" if first
                                else None))
    outs = {who: torch.load(out_dir / f"{who}.pt") for who in times}
    failed = []
    for shape, *_, calls in _shapes():
        for name in ("k1", "k2"):
            key = f"{name} {shape}"
            err = (outs["other"][key].float()
                   - outs["this"][key].float()).abs().max().item()
            if not err < BF16_TOL:
                failed.append(f"{key}: max |other - this| {err}")
            print(f"[ab] {key} bf16, L2-cold ms: other "
                  f"{times['other'][0][key]:.4f} {times['other'][1][key]:.4f}"
                  f", this {times['this'][0][key]:.4f} "
                  f"{times['this'][1][key]:.4f}; max |other - this| "
                  f"{err:.3g}; calls/forward={calls}", flush=True)
    for name in ("k1", "k2"):
        sums = {who: sum(calls * statistics.mean(t[f"{name} {shape}"]
                                                 for t in times[who])
                         for shape, *_, calls in _shapes())
                for who in times}
        print(f"[ab] {name} per bf16 forward (14 calls), L2-cold, mean of "
              f"two turns: other {sums['other']:.4f} ms, this "
              f"{sums['this']:.4f} ms", flush=True)
    print(card, flush=True)
    if failed:
        sys.exit("kernel_ab: the trees disagree:\n" + "\n".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
