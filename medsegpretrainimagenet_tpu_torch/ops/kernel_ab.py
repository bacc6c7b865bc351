"""Time this tree's K1 and K2 against another checkout's, on the card, in turns.

    python -m medsegpretrainimagenet_tpu_torch.ops.kernel_ab OTHER_CHECKOUT \
        [--dtype bfloat16|float32] [--serve | --backward]

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

``--backward`` times the backward kernels instead
(``window_attention_backward_cuda``, ``image_attention_backward_cuda``, at
the same shapes with a random cotangent, dbias asked for and dmask not, as
a training step asks): the bf16 shapes are also those of one
``swin_224_train`` step.  Both trees need the backward kernels; the
gradients (dq, dk, dv or dqkv, then dbias) must agree within the dtype's
bar, dbias relative to its largest value.

``--serve`` times serving instead, each tree through its own package in
turns (other, this, this, other, twice): ``swin_unet_224`` in bf16 at
batch 24 with random weights from one seed, on each attention layout (K1,
K2): the wall time of a no-grad eager forward, the host's time to queue
one, the host's time per attention call, and
``predict_from_config``'s images/s over 96 images (``[ab serve]`` lines).
The first turn of each tree saves its K1 path's output, and the two must
agree within the bf16 bar.  That is where a change to the wrappers' host
side (the operators' dispatch) shows.

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

#: --serve: images per predict_from_config call, forwards per timed run
SERVE_IMAGES, SERVE_FORWARDS = 96, 20


def swin_unet_224_config() -> dict:
    """``swin_unet_224`` as ``chip_smoke.py`` serves it: Swin-Unet (Cao et
    al., arXiv:2105.05537) as the reference ships it in
    config/downstream/covidqu/swin_unet.yaml."""
    return {"model": {"segmentation.models.UNet": {"architecture": {
        "in_channel_size": 3, "out_channel_size": 1, "depth": 3, "width": 2,
        "channels": (96, 192, 384, 768), "change_channels_in_block": False,
        "trainable_downsampling": True, "stochastic depth rate": 0.2,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": 224, "patch_size": 4, "embed_dim": 96,
            "num_heads_layers": (3, 6, 12, 24), "window_size": 7,
            "mlp_ratio": 4.0}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 4}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "upsampling": {"segmentation.models.blocks.PatchExpand": {
            "dim_scale": 2}},
        "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {}},
        "final_block": {"segmentation.models.blocks.FinalPatchExpand_X4": {
            "dim_scale": 4}},
        "activation function": {"final": "sigmoid"},
    }}}}


def hold_stream(calls: int, host_s: float = 0.0) -> None:
    """Hold the current stream with a spin kernel long enough (about 0.2
    ms a call, or twice *host_s*, the host's seconds to queue one call, if
    that is longer) for the host to queue *calls* calls behind it, so that
    the events around them time the device and not the host's launch
    rate: a small kernel runs faster than Python can launch it."""
    import torch

    # about 2e9 spin cycles a second
    torch.cuda._sleep(max(400_000, int(2 * host_s * 2e9)) * calls)


def input_copies(*tensors) -> list:
    """*tensors* and as many clones as make all of them together exceed
    twice the card's L2, for :func:`device_ms`."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(2 * L2_BYTES // nbytes)]


def device_ms(fn, copies: list, runs: int = 3,
              host_bound: bool = False) -> float:
    """Device time of ``fn(*inputs)`` per call: the mean over back-to-back
    calls that rotate over *copies* of the inputs, from CUDA events around
    them, and the median of *runs* such runs.  With one copy the inputs
    stay in the L2 where they fit (warm); with :func:`input_copies` each
    call finds its inputs evicted by the calls before it (L2-cold), as a
    layer of the model finds its activations.  A host stall longer than
    :func:`hold_stream` covers leaves a gap inside one run; the median
    drops that run.  *host_bound*: *fn* takes the host longer to queue
    than 0.2 ms (autograd's backward of a library call), so the stream is
    held for twice the host's time per call, measured in the warm-up."""
    import time

    import torch

    warm = max(3, len(copies))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warm):
        fn(*copies[i % len(copies)])
    host_s = (time.perf_counter() - t0) / warm if host_bound else 0.0
    iters = max(20, 2 * len(copies))
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        hold_stream(iters, host_s)
        start.record()
        for i in range(iters):
            fn(*copies[i % len(copies)])
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times)


def instance_label(symbol: str) -> str:
    """``window_attention<f32, DP 32>`` (``window_attention_bwd<...>`` for
    the backward) for the mangled symbol of an instance of the attention
    kernels (a template on the element type and D padded to 16, or, in
    older trees, ``window_attention_bf16<DP>``), else the symbol itself."""
    base = re.search(r"((?:window|image)_attention(?:_bwd)?)(?:_bf16)?I",
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


def _worker(tree: Path, save: Optional[Path], dtype_name: str,
            backward: bool = False) -> None:
    """Time *tree*'s kernels (with *backward*, their backward kernels) at
    every shape of *dtype_name*'s forward; print ``{shape: ms}`` as JSON
    and, with *save*, write the outputs (the gradients, dbias divided by
    its largest magnitude, flattened and joined) there."""
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

        cases = [("k1", k1, (q, k, v)), ("k2", k2, (qkv,))]
        if backward:
            g1 = torch.randn(q.shape, generator=gen).to("cuda", dtype)
            g2 = torch.randn(qkv.shape[:3] + (qkv.shape[3] // 3,),
                             generator=gen).to("cuda", dtype)

            def k1(q, k, v, g):
                return wa.window_attention_backward_cuda(
                    q, k, v, bias, mask, scale, g, mask_grad=False)

            def k2(qkv, g):
                return wa.image_attention_backward_cuda(
                    qkv, bias, mask, scale, WINDOW, g, mask_grad=False)

            cases = [("k1", k1, (q, k, v, g1)), ("k2", k2, (qkv, g2))]
        for name, fn, inputs in cases:
            if save is not None:
                out = fn(*inputs)
                outs[f"{name} {shape}"] = (_joined(out) if backward
                                           else out).cpu()
            copies = input_copies(*inputs)
            times[f"{name} {shape}"] = device_ms(fn, copies)
            del copies
    if save is not None:
        torch.save(outs, save)
    from medsegpretrainimagenet_tpu_torch.ops import _build

    libraries = {name: info["path"] for name, info in _build.build().items()}
    print(json.dumps({"times": times, "libraries": libraries}), flush=True)


def _joined(grads):
    """A backward's gradients as one flat tensor (the dtype of the first):
    the inputs', then dbias divided by its largest magnitude."""
    import torch

    *inputs, dbias, _ = grads
    return torch.cat([t.reshape(-1) for t in inputs]
                     + [(dbias / dbias.abs().max()).reshape(-1)
                        .to(inputs[0].dtype)])


def _serve_worker(tree: Path, save: Optional[Path]) -> None:
    """Time *tree*'s serving of swin_unet_224 in bf16 at batch BATCH, on
    the windows layout (K1) and the image layout (K2): the wall time per
    no-grad forward over SERVE_FORWARDS back-to-back forwards (median of
    three runs), the host's time to queue one forward (median of seven),
    the host's time per attention call (:func:`_call_host_us`), and
    predict_from_config's images/s over SERVE_IMAGES images (median of
    three calls).  Print them as JSON and, with *save*,
    write the K1 path's output there."""
    sys.path[0] = str(tree)
    import time

    import numpy as np
    import torch

    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.models.blocks import \
        set_compute_dtype
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.predict import predict_from_config
    from medsegpretrainimagenet_tpu_torch.train.checkpoint import \
        save_params_file

    if not Path(ops.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {ops.__file__}, not {tree}'s package")
    work = tree / "build" / "serve_ab"
    work.mkdir(parents=True, exist_ok=True)
    imgs = (np.random.default_rng(0).random((SERVE_IMAGES, 1, 224, 224))
            * 255).astype(np.uint8)
    np.save(work / "imgs.npy", imgs)
    set_compute_dtype(torch.bfloat16)
    cd = ConfigDict(swin_unet_224_config())
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    save_params_file(str(work / "w.pt"), model.init(seed=0))
    module = model.module.cuda().eval()
    x = torch.from_numpy(np.repeat(imgs[:BATCH].transpose(0, 2, 3, 1), 3,
                                   axis=-1)).cuda().float() / 255.0
    times = {}
    try:
        for mode, path in (("off", "k1"), ("on", "k2")):
            ops.set_fused_image_mode(mode)
            with torch.inference_mode():
                for _ in range(3):
                    out = module(x)
                torch.cuda.synchronize()
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(SERVE_FORWARDS):
                        out = module(x)
                    torch.cuda.synchronize()
                    walls.append(1e3 * (time.perf_counter() - t0)
                                 / SERVE_FORWARDS)
                # the host's share: one forward queued on the card, no wait
                hosts = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    module(x)
                    hosts.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize()
            if path == "k1" and save is not None:
                torch.save(out.float().cpu(), save)
            times[f"{path} forward ms"] = statistics.median(walls)
            times[f"{path} forward host ms"] = statistics.median(hosts)
            times[f"{path} call host us"] = _call_host_us(wa, path)
            times[f"{path} predict images/s"] = statistics.median(
                predict_from_config(
                    ConfigDict(swin_unet_224_config()), str(work / "w.pt"),
                    str(work / "imgs.npy"), str(work / "out.npy"),
                    batch_size=BATCH, mixed_precision=True,
                    device="cuda")["images_per_sec"] for _ in range(3))
    finally:
        ops.set_fused_image_mode("off")
        set_compute_dtype(None)
    print(json.dumps({"times": times}), flush=True)


def _call_host_us(wa, path: str, calls: int = 100) -> float:
    """Host microseconds per no-grad call of the attention entry point of
    *path* (``window_attention_core`` for "k1",
    ``fused_image_window_attention`` for "k2") at level 0 of the serving
    forward (a masked call), queued back to back without a wait: the
    wrapper's dispatch and launch.  Median of seven runs."""
    import time

    import torch

    from medsegpretrainimagenet_tpu_torch.models.swin import _shift_attn_mask

    gen = torch.Generator().manual_seed(5)
    heads, n_w = 3, 64
    bias = (0.02 * torch.randn(heads, TOKENS, TOKENS, generator=gen)).cuda()
    mask = torch.from_numpy(_shift_attn_mask((56, 56), WINDOW,
                                             WINDOW // 2)).cuda()
    scale = HEAD_DIM ** -0.5
    if path == "k1":
        q, k, v = (torch.randn(BATCH * n_w, heads, TOKENS, HEAD_DIM,
                               generator=gen).to("cuda", torch.bfloat16)
                   for _ in range(3))

        def call():
            return wa.window_attention_core(q, k, v, bias, mask, scale)
    else:
        qkv = torch.randn(BATCH, 56, 56, 3 * heads * HEAD_DIM,
                          generator=gen).to("cuda", torch.bfloat16)

        def call():
            return wa.fused_image_window_attention(qkv, bias, mask, scale,
                                                   WINDOW)
    walls = []
    with torch.inference_mode():
        for _ in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            walls.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(walls[1:])


def _serve_main(other: Path, card: str) -> int:
    """--serve: the turns of :func:`_serve_worker`, their ``[ab serve]``
    lines and the check that both trees serve the same outputs."""
    import torch

    out_dir = THIS / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    times = {"other": [], "this": []}
    for who, tree in (("other", other), ("this", THIS), ("this", THIS),
                      ("other", other)) * 2:
        first = not times[who]
        times[who].append(_turn(tree, out_dir / f"{who}-serve.pt" if first
                                else None, "bfloat16", serve=True)["times"])
    a, b = (torch.load(out_dir / f"{who}-serve.pt") for who in times)
    err = (a - b).abs().max().item()
    for key in times["this"][0]:
        row = {who: [round(t[key], 4) for t in times[who]] for who in times}
        print(f"[ab serve] swin_unet_224 bf16 batch {BATCH}, {key}: other "
              f"median {statistics.median(row['other']):.4f} of "
              f"{row['other']}, this median "
              f"{statistics.median(row['this']):.4f} of {row['this']}",
              flush=True)
    print(f"[ab serve] K1 path's outputs: max |other - this| {err:.3g} "
          f"(bar {BF16_TOL}), bit-equal {'yes' if torch.equal(a, b) else 'no'}",
          flush=True)
    print(card, flush=True)
    if not err < BF16_TOL:
        sys.exit(f"kernel_ab: the trees serve different outputs ({err})")
    return 0


def _turn(tree: Path, save: Optional[Path], dtype: str,
          serve: bool = False, backward: bool = False) -> dict:
    cmd = [sys.executable, __file__, "--worker", str(tree), "--dtype", dtype]
    if serve:
        cmd.append("--serve")
    if backward:
        cmd.append("--backward")
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
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--serve", action="store_true",
                      help="time swin_unet_224's bf16 serving (eager "
                           "forward, predict_from_config) instead of the "
                           "kernels")
    mode.add_argument("--backward", action="store_true",
                      help="time the backward kernels instead of the "
                           "forwards")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker is not None:
        if args.serve:
            _serve_worker(args.worker.resolve(), args.save)
        else:
            _worker(args.worker.resolve(), args.save, args.dtype,
                    args.backward)
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
    if args.serve:
        return _serve_main(other, card)
    out_dir = THIS / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    times = {"other": [], "this": []}
    libraries = {}
    kind = "bwd" if args.backward else "fwd"
    for who, tree in (("other", other), ("this", THIS), ("this", THIS),
                      ("other", other)):
        first = not times[who]
        turn = _turn(tree, out_dir / f"{who}-{args.dtype}-{kind}.pt"
                     if first else None, args.dtype,
                     backward=args.backward)
        times[who].append(turn["times"])
        libraries[who] = turn["libraries"]
    outs = {who: torch.load(out_dir / f"{who}-{args.dtype}-{kind}.pt")
            for who in times}
    _, _, tol, forward = CASES[args.dtype]
    label = "bf16" if args.dtype == "bfloat16" else "f32"
    if args.backward:
        label += " backward"
        forward += " (its backward)"
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
