"""Time this tree's K1 and K2 against another checkout's, on the card, in turns.

    python -m medsegpretrainimagenet_tpu_torch.ops.kernel_ab OTHER_CHECKOUT \
        [--dtype bfloat16|float32]

Each tree's kernels are built from its own ``csrc/`` and called through its
own wrappers (``window_attention_cuda``, ``image_attention_cuda``) in a
process that imports only that tree's package, so the two trees' C
interfaces need not agree.  The processes run in turns, other, this, this,
other; each times K1 and K2 at the attention shapes of one forward,
L2-cold (:func:`device_ms` over :func:`input_copies`), on the same inputs
made from one seed: in bf16 (the default) the seven level shapes of
``swin_unet_224`` at batch 24, in float32 those of ``robustness_224``'s
Swin encoder at 32 probes.  The first turn of each tree also saves its
outputs under ``build/kernel_ab/``, and the two trees' outputs must agree
within the dtype's bar (bf16 0.05, float32 1e-4); each ``[ab]`` line says
whether they are equal bit for bit.  Prints the card's name and power
limit, ``[ab]`` lines per shape, the sums per forward, and exits non-zero
on any failure.

Then it compares the two trees' kernel libraries instance by instance
(``cuobjdump``): ``[ab sass]`` lines give each instance's instruction
count, opcode sequence and registers in both trees, so a change that
leaves an instance's code as it was shows as such.

The timing and SASS helpers here are also ``chip_smoke.py``'s.  Nothing
runs at import, and the module imports nothing of the package: a worker
imports the package of the tree it times.
"""
from __future__ import annotations

import argparse
import json
import re
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
#: the same for robustness_224's Swin encoder (depth 3, width 2: one W-MSA
#: and one SW-MSA call per level, two W-MSA at the one-window bottom) at 32
#: probes, chip_smoke.py's ROB_ATTENTION
ROB_PROBES = 32
ROB_LEVELS = [(0, 3, 64, 1, 1), (1, 6, 16, 1, 1), (2, 12, 4, 1, 1),
              (3, 24, 1, 0, 2)]
TOKENS, HEAD_DIM, WINDOW = 49, 32, 7
BF16_TOL, F32_TOL = 0.05, 1e-4
#: per dtype: (batch, level shapes, bar on |other - this|, the forward)
CASES = {"bfloat16": (BATCH, LEVELS, BF16_TOL, "bf16 forward of "
                                               "swin_unet_224"),
         "float32": (ROB_PROBES, ROB_LEVELS, F32_TOL,
                     "f32 Swin encoder forward of robustness_224")}

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


def instance_label(symbol: str) -> str:
    """``window_attention<f32, DP 32>`` for the mangled symbol of an
    instance of the attention kernels (a template on the element type and D
    padded to 16, or, in older trees, ``window_attention_bf16<DP>``), else
    the symbol itself."""
    base = re.search(r"(window_attention|image_attention)(?:_bf16)?I",
                     symbol)
    dp = re.search(r"Li(\d+)E", symbol)
    if base is None or dp is None:
        return symbol
    dtype = "bf16" if "__nv_bfloat16" in symbol else "f32"
    return f"{base.group(1)}<{dtype}, DP {dp.group(1)}>"


def parse_sass(sass: str, usage: str = "") -> dict:
    """``{mangled symbol: (instructions, registers)}`` from ``cuobjdump
    -sass`` (*sass*) and ``cuobjdump -res-usage`` (*usage*; registers None
    without it): each instruction's text without its address and encoding,
    predicate included."""
    registers = dict(re.findall(r"Function (\S+):\s*REG:(\d+)", usage))
    out = {}
    for function in sass.split("Function : ")[1:]:
        symbol = function.split()[0]
        code = [m.group(1).strip() for m in
                (re.match(r"\s*/\*[0-9a-f]+\*/\s+([^;]+);", line)
                 for line in function.splitlines()) if m]
        regs = registers.get(symbol)
        out[symbol] = (code, None if regs is None else int(regs))
    return out


def opcodes(code: list) -> list:
    """The opcode (with its modifiers) of each instruction of *code*."""
    return [t[1] if t[0].startswith("@") else t[0]
            for t in (line.split() for line in code)]


def library_sass(library: str) -> dict:
    """:func:`parse_sass` of a built kernel library, by instance label."""
    from . import _build

    cuobjdump = str(Path(_build.nvcc()).parent / "cuobjdump")
    sass, usage = (subprocess.run([cuobjdump, flag, library],
                                  capture_output=True, text=True, timeout=120,
                                  check=True).stdout
                   for flag in ("-sass", "-res-usage"))
    return {instance_label(symbol): code
            for symbol, code in parse_sass(sass, usage).items()}


def _shapes(dtype: str = "bfloat16"):
    """(name, level, heads, windows per image, masked, calls per forward)
    of *dtype*'s forward"""
    for level, heads, n_w, n_masked, n_plain in CASES[dtype][1]:
        for masked, calls in ((False, n_plain), (True, n_masked)):
            if calls:
                yield (f"level {level} {'SW-MSA' if masked else 'W-MSA '}",
                       level, heads, n_w, masked, calls)


def _worker(tree: Path, save: Optional[Path], dtype_name: str) -> None:
    """Time *tree*'s kernels at every shape of *dtype_name*'s forward;
    print ``{shape: ms}`` as JSON and, with *save*, write the outputs
    there."""
    sys.path[0] = str(tree)  # the tree's package, not the one beside us
    import torch

    from medsegpretrainimagenet_tpu_torch.models.swin import _shift_attn_mask
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    if not Path(wa.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {wa.__file__}, not {tree}'s package")
    gen = torch.Generator().manual_seed(4)
    scale = HEAD_DIM ** -0.5
    dtype = getattr(torch, dtype_name)
    batch = CASES[dtype_name][0]
    times, outs = {}, {}
    for shape, level, heads, n_w, masked, _ in _shapes(dtype_name):
        res = 56 // 2 ** level
        q, k, v = (torch.randn(batch * n_w, heads, TOKENS, HEAD_DIM,
                               generator=gen).to("cuda", dtype)
                   for _ in range(3))
        qkv = torch.randn(batch, res, res, 3 * heads * HEAD_DIM,
                          generator=gen).to("cuda", dtype)
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
    from medsegpretrainimagenet_tpu_torch.ops import _build

    libraries = {name: info["path"] for name, info in _build.build().items()}
    print(json.dumps({"times": times, "libraries": libraries}), flush=True)


def _turn(tree: Path, save: Optional[Path], dtype: str) -> dict:
    cmd = [sys.executable, __file__, "--worker", str(tree), "--dtype", dtype]
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
    parser.add_argument("--dtype", choices=sorted(CASES),
                        default="bfloat16",
                        help="bfloat16: swin_unet_224's serving shapes "
                             "(the default); float32: robustness_224's")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        _worker(args.worker.resolve(), args.save, args.dtype)
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
    libraries = {}
    for who, tree in (("other", other), ("this", THIS), ("this", THIS),
                      ("other", other)):
        first = not times[who]
        turn = _turn(tree, out_dir / f"{who}-{args.dtype}.pt" if first
                     else None, args.dtype)
        times[who].append(turn["times"])
        libraries[who] = turn["libraries"]
    outs = {who: torch.load(out_dir / f"{who}-{args.dtype}.pt")
            for who in times}
    _, _, tol, forward = CASES[args.dtype]
    label = "bf16" if args.dtype == "bfloat16" else "f32"
    shapes = list(_shapes(args.dtype))
    failed = []
    for shape, *_, calls in shapes:
        for name in ("k1", "k2"):
            key = f"{name} {shape}"
            a, b = outs["other"][key], outs["this"][key]
            err = (a.float() - b.float()).abs().max().item()
            if not err < tol:
                failed.append(f"{key}: max |other - this| {err}")
            print(f"[ab] {key} {label}, L2-cold ms: other "
                  f"{times['other'][0][key]:.4f} {times['other'][1][key]:.4f}"
                  f", this {times['this'][0][key]:.4f} "
                  f"{times['this'][1][key]:.4f}; max |other - this| "
                  f"{err:.3g} (bar {tol}), bit-equal "
                  f"{'yes' if torch.equal(a, b) else 'no'}; "
                  f"calls/forward={calls}", flush=True)
    for name in ("k1", "k2"):
        sums = {who: sum(calls * statistics.mean(t[f"{name} {shape}"]
                                                 for t in times[who])
                         for shape, *_, calls in shapes)
                for who in times}
        print(f"[ab] {name} per {forward} "
              f"({sum(s[-1] for s in shapes)} calls), L2-cold, mean of two "
              f"turns: other {sums['other']:.4f} ms, this "
              f"{sums['this']:.4f} ms", flush=True)
    for name in sorted(set(libraries["other"]) & set(libraries["this"])):
        sass = {who: library_sass(libraries[who][name]) for who in libraries}
        for label in sorted(set(sass["other"]) & set(sass["this"])):
            (a, ra), (b, rb) = sass["other"][label], sass["this"][label]
            print(f"[ab sass] {label}: other {len(a)} instructions, {ra} "
                  f"registers; this {len(b)}, {rb}; opcodes equal "
                  f"{'yes' if opcodes(a) == opcodes(b) else 'no'}, "
                  f"instructions equal {'yes' if a == b else 'no'}",
                  flush=True)
    print(card, flush=True)
    if failed:
        sys.exit("kernel_ab: the trees disagree:\n" + "\n".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
