#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (medsegpretrainimagenet_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
all at once) and counts the tensor-core instructions (HMMA) of each kernel
instance in its SASS: a bf16 instance without any fails.  It holds each
kernel against its plain PyTorch version on the card at the shapes the
serving path gives it: K1 (window attention, windows layout) and K2 (the
image-layout path, which also holds against the K1 path on the same input),
on the max and the mean |kernel - plain|; the mean bar is checked to sit
far under what a dropped or misaddressed bias or mask would read.  Each is
timed L2-cold (the calls rotate over copies of the inputs that together
exceed twice the L2) and warm, beside its plain version, one PyTorch
library call and the bound.  (To time K1 and K2 against another checkout,
see ``medsegpretrainimagenet_tpu_torch/ops/kernel_ab.py``.)  It drives the
full-width Swin U-Net 224 (``swin_unet_224``, random weights from a seed)
through the port's ``predict_from_config`` in bf16 on both paths, the
windows layout through K1 and the image layout through K2
(``set_fused_image_mode("on")``), checks that each went through its kernel,
and that their outputs agree with each other, with the plain attention and,
on a small input, with the CPU.  It times both paths in turns and profiles
one call of each.  Any failure exits non-zero.  Without a CUDA card, or
without the package beside it, it exits non-zero and prints no result.  It
imports nothing of JAX.

The last lines are the card's name and power limit, a JSON line with each
kernel's launches, error and times, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM: device-memory rate and dense peak rates (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

#: attention shapes of swin_unet_224 at batch 24: (level, heads, windows
#: per image, masked calls per forward, unmasked calls per forward); level
#: l has resolution 56 / 2^l and 96 * 2^l channels
BATCH = 24
LEVELS = [(0, 3, 64, 2, 2), (1, 6, 16, 2, 2), (2, 12, 4, 2, 2),
          (3, 24, 1, 0, 2)]
TOKENS, HEAD_DIM, WINDOW = 49, 32, 7
BF16_TOL, F32_TOL = 0.05, 1e-4
#: bars on the mean |kernel - plain|.  A sound bf16 kernel reads about 1e-7
#: (a bf16 step on a few outputs); one that drops the bias or reads another
#: head's bias or another window's mask reads 1e-3 or more, under the max
#: bar all the same (phase_k1 and phase_k2 measure both and check that
#: the bar sits between them)
MEAN_TOL = {"torch.bfloat16": 1e-5, "torch.float32": 1e-6}
#: how far under the least fault reading the mean bar must sit
FAULT_MARGIN = 10
SERVE_IMAGES, SERVE_TOL = 96, 2e-2


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def swin_unet_224_config() -> dict:
    """``swin_unet_224``: Swin-Unet (Cao et al., arXiv:2105.05537) as the
    reference ships it in config/downstream/covidqu/swin_unet.yaml."""
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


def phase_build():
    from medsegpretrainimagenet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    check(set(built) >= {"window_attention"},
          f"kernels built: {sorted(built)}")
    cuobjdump = str(Path(_build.nvcc()).parent / "cuobjdump")
    for name, info in built.items():
        print(f"[build] {name}: {info['seconds']:.2f} s"
              f"{' (cached)' if info['cached'] else ''}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
        # tensor-core instructions per kernel instance, from the SASS: the
        # check that the bf16 instances are the tensor-core body
        sass = subprocess.run([cuobjdump, "-sass", info["path"]],
                              capture_output=True, text=True, timeout=120)
        check(sass.returncode == 0, f"cuobjdump -sass {info['path']}: "
                                    f"{sass.stderr.strip()}")
        for function in sass.stdout.split("Function : ")[1:]:
            symbol = function.split()[0]
            hmma = function.count("HMMA")
            print(f"[build]   {symbol}: {hmma} HMMA")
            check(hmma > 0 or "bfloat16" not in symbol,
                  f"{symbol}: a bf16 instance without tensor-core "
                  f"instructions")
    print(f"[build] all kernels: {seconds:.2f} s", flush=True)


def _k1_inputs(level, heads, n_w, masked, dtype, generator):
    import torch

    windows = BATCH * n_w
    q, k, v = (torch.randn(windows, heads, TOKENS, HEAD_DIM,
                           generator=generator).to("cuda", dtype)
               for _ in range(3))
    return (q, k, v, *_tables(level, heads, masked, generator))


def _tables(level, heads, masked, generator):
    """A level's relative-position bias (from a random table) and, for
    SW-MSA, its shift mask, float32 on the card."""
    import torch

    from medsegpretrainimagenet_tpu_torch.models.swin import (
        _relative_position_index, _shift_attn_mask)

    table = torch.randn((2 * WINDOW - 1) ** 2, heads,
                        generator=generator) * 0.02
    index = torch.from_numpy(_relative_position_index((WINDOW, WINDOW)))
    bias = table[index.reshape(-1)].reshape(TOKENS, TOKENS, heads) \
        .permute(2, 0, 1).contiguous().cuda()
    mask = None
    if masked:
        resolution = 56 // 2 ** level
        mask = torch.from_numpy(_shift_attn_mask(
            (resolution, resolution), WINDOW, WINDOW // 2)).cuda()
    return bias, mask


def _k1_bound_ms(q, bias, mask):
    """(bytes time, operations time) in ms: q, k, v, bias and mask read
    once and out written once over the memory rate; the two products'
    operations over the peak rate for the input type."""
    moved = 4 * q.numel() * q.element_size() + bias.numel() * 4 \
        + (0 if mask is None else mask.numel() * 4)
    b_, h, n, d = q.shape
    ops = 4 * b_ * h * n * n * d
    return (1e3 * moved / HBM_BYTES_PER_S,
            1e3 * ops / PEAK_OPS_PER_S[str(q.dtype)])


def hold(what: str, out, ref, plain, bias, mask):
    """Hold a kernel's *out* against *ref*, its plain version's output, on
    the max and the mean |kernel - plain|.  Then check that the mean bar
    would catch a kernel that addressed its tables wrongly: the plain
    version recomputed by ``plain(bias, mask)`` with the bias dropped, with
    the next head's bias and, under SW-MSA, with the next window's mask,
    must each read at least FAULT_MARGIN times the bar.  Returns (max,
    mean, the least fault reading)."""
    import torch

    diff = (out.float() - ref.float()).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    tol = BF16_TOL if out.dtype == torch.bfloat16 else F32_TOL
    mean_tol = MEAN_TOL[str(out.dtype)]
    check(err < tol and mean_err < mean_tol
          and torch.isfinite(out).all().item(),
          f"{what}: |kernel - plain| max {err} (bar {tol}), mean {mean_err} "
          f"(bar {mean_tol})")
    faults = [(torch.zeros_like(bias), mask), (bias.roll(1, 0), mask)]
    if mask is not None:
        faults.append((bias, mask.roll(1, 0)))
    fault = min((plain(b, m).float() - ref.float()).abs().mean().item()
                for b, m in faults)
    check(fault > FAULT_MARGIN * mean_tol,
          f"{what}: a kernel with a misaddressed table would read a mean "
          f"|kernel - plain| of {fault}, too close to the bar {mean_tol}")
    return err, mean_err, fault


def phase_k1():
    """K1 against its plain version at every level shape of the forward,
    W-MSA and SW-MSA, bf16 and f32; times per shape; one backward."""
    import torch
    import torch.nn.functional as F

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import (
        device_ms, input_copies)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    scale = HEAD_DIM ** -0.5
    per_forward = {"ms": 0.0, "warm_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "library_ms": 0.0, "library_warm_ms": 0.0,
                   "bytes_ms": 0.0, "ops_ms": 0.0}
    errs = {torch.bfloat16: [], torch.float32: []}
    for level, heads, n_w, n_masked, n_plain in LEVELS:
        for masked in (False, True):
            if masked and n_masked == 0:
                continue
            calls = n_masked if masked else n_plain
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, bias, mask = _k1_inputs(level, heads, n_w, masked,
                                                 dtype, gen)
                out = wa.window_attention_cuda(q, k, v, bias, mask, scale)

                def plain(bias, mask):
                    return wa.window_attention_core(q, k, v, bias, mask,
                                                    scale, force="torch")

                err, mean_err, fault = hold(
                    f"K1 level {level} masked={masked} {dtype}", out,
                    plain(bias, mask), plain, bias, mask)
                errs[dtype].append((err, mean_err, fault))
                if dtype != torch.bfloat16:
                    continue
                # SDPA with bias and mask folded into one additive mask:
                # timed as a yardstick only, the port never calls it
                full = _sdpa_mask(bias, mask, q.shape[0], dtype)

                def kernel(q, k, v):
                    return wa.window_attention_cuda(q, k, v, bias, mask,
                                                    scale)

                def library(q, k, v):
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=full, scale=scale)

                copies = input_copies(q, k, v)
                t_kernel = device_ms(kernel, copies)
                t_plain = device_ms(lambda q, k, v: wa.window_attention_torch(
                    q, k, v, bias, mask, scale), copies)
                t_lib = device_ms(library, copies)
                t_kernel_warm = device_ms(kernel, copies[:1])
                t_lib_warm = device_ms(library, copies[:1])
                del copies
                t_bytes, t_ops = _k1_bound_ms(q, bias, mask)
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                print(f"[k1] level {level} B_={q.shape[0]} H={heads} "
                      f"{'SW-MSA' if masked else 'W-MSA '} bf16, L2-cold: "
                      f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} "
                      f"library_ms={t_lib:.4f} bound_ms={bound:.4f} "
                      f"({by}); warm: kernel_ms={t_kernel_warm:.4f} "
                      f"library_ms={t_lib_warm:.4f}; |kernel - plain| "
                      f"max={err:.3g} mean={mean_err:.3g} (a misaddressed "
                      f"table: mean >= {fault:.3g}); calls/forward={calls}",
                      flush=True)
                per_forward["ms"] += calls * t_kernel
                per_forward["warm_ms"] += calls * t_kernel_warm
                per_forward["plain_ms"] += calls * t_plain
                per_forward["library_ms"] += calls * t_lib
                per_forward["library_warm_ms"] += calls * t_lib_warm
                per_forward["bound_ms"] += calls * bound
                per_forward["bytes_ms"] += calls * t_bytes
                per_forward["ops_ms"] += calls * t_ops
    print_errors("k1", errs)
    print(f"[k1] per bf16 forward (14 calls), L2-cold: kernel "
          f"{per_forward['ms']:.4f} ms (warm {per_forward['warm_ms']:.4f}), "
          f"plain {per_forward['plain_ms']:.4f} ms, SDPA "
          f"{per_forward['library_ms']:.4f} ms (warm "
          f"{per_forward['library_warm_ms']:.4f}), bound "
          f"{per_forward['bound_ms']:.4f} ms", flush=True)

    # one backward through the autograd Function (kernel forward,
    # recompute backward) against autograd through the plain version;
    # the same float32 math in another order, TF32 off
    q, k, v, bias, mask = _k1_inputs(0, 3, 64, True, torch.float32, gen)
    g = torch.randn(q.shape, generator=gen).cuda()
    grads = []
    for force in (None, "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias, mask)]
        (wa.window_attention_core(*leaves, scale, force=force) * g) \
            .sum().backward()
        grads.append([t.grad for t in leaves])
    grad_err = max((a - b).abs().max().item()
                   for a, b in zip(*grads))
    check(grad_err < 1e-3, f"K1 backward: max |Function - autograd| "
                           f"{grad_err}")
    print(f"[k1] backward max |Function - plain autograd| {grad_err:.3g}",
          flush=True)
    bound_by = "bytes" if per_forward["bytes_ms"] >= per_forward["ops_ms"] \
        else "operations"
    return per_forward, bound_by, max(e[0] for e in errs[torch.bfloat16])


def print_errors(kernel: str, errs: dict) -> None:
    """The worst of the (max, mean, fault) readings of each dtype."""
    for dtype, readings in errs.items():
        name = str(dtype).split(".")[-1]
        print(f"[{kernel}] {name} |kernel - plain| over all shapes: max "
              f"{max(e[0] for e in readings):.3g} (bar "
              f"{BF16_TOL if name == 'bfloat16' else F32_TOL}), mean at "
              f"most {max(e[1] for e in readings):.3g} (bar "
              f"{MEAN_TOL[str(dtype)]}); a misaddressed table reads a mean "
              f"of at least {min(e[2] for e in readings):.3g}", flush=True)


def _sdpa_mask(bias, mask, windows, dtype):
    """bias and mask folded into one additive (B_, H, N, N) mask for SDPA."""
    heads = bias.shape[0]
    full = bias[None].expand(windows, -1, -1, -1)
    if mask is not None:
        n_w = mask.shape[0]
        full = (full.reshape(windows // n_w, n_w, heads, TOKENS, TOKENS)
                + mask[None, :, None]).reshape(full.shape)
    return full.to(dtype).contiguous()


def _k1_path(qkv, bias, mask, scale):
    """The windows-layout path on an image-layout qkv, with the layout
    copies of SwinTransformerBlock.forward and WindowAttention.forward:
    window_partition, head split, K1, head merge, window_reverse."""
    from medsegpretrainimagenet_tpu_torch.models.swin import (
        window_partition, window_reverse)
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    b, res, _, c3 = qkv.shape
    heads, c = bias.shape[0], c3 // 3
    windows = window_partition(qkv, WINDOW).reshape(-1, TOKENS, 3, heads,
                                                    c // heads)
    q, k, v = windows.permute(2, 0, 3, 1, 4).contiguous()
    out = wa.window_attention_cuda(q, k, v, bias, mask, scale)
    out = out.transpose(1, 2).reshape(-1, WINDOW, WINDOW, c)
    return window_reverse(out, WINDOW, res, res)


def _sdpa_image_path(qkv, full, scale):
    """The library yardstick for K2: the image-to-windows layout permute of
    qkv, SDPA with bias and mask folded into *full*, the permute back."""
    import torch.nn.functional as F

    b, res, _, c3 = qkv.shape
    heads = full.shape[1]
    n_wc, d = res // WINDOW, c3 // 3 // heads
    t = qkv.reshape(b, n_wc, WINDOW, n_wc, WINDOW, 3, heads, d)
    t = t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, TOKENS, d)
    out = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=full,
                                         scale=scale)
    out = out.reshape(b, n_wc, n_wc, heads, WINDOW, WINDOW, d)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, res, res, c3 // 3)


def phase_k2():
    """K2 against its plain version and against the K1 path at every level
    shape of the forward, W-MSA and SW-MSA, bf16 and f32; times per shape
    beside the K1 path, the library yardstick and the bound; one
    backward."""
    import torch

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import (
        device_ms, input_copies)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    scale = HEAD_DIM ** -0.5
    per_forward = {"ms": 0.0, "warm_ms": 0.0, "plain_ms": 0.0,
                   "k1_path_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                   "library_warm_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    errs = {torch.bfloat16: [], torch.float32: []}
    for level, heads, n_w, n_masked, n_plain in LEVELS:
        res = 56 // 2 ** level
        for masked in (False, True):
            if masked and n_masked == 0:
                continue
            calls = n_masked if masked else n_plain
            for dtype in (torch.bfloat16, torch.float32):
                qkv = torch.randn(BATCH, res, res, 3 * heads * HEAD_DIM,
                                  generator=gen).to("cuda", dtype)
                bias, mask = _tables(level, heads, masked, gen)
                out = wa.image_attention_cuda(qkv, bias, mask, scale, WINDOW)

                def plain(bias, mask):
                    return wa.fused_image_window_attention(
                        qkv, bias, mask, scale, WINDOW, force="torch")

                ref = plain(bias, mask)
                what = f"K2 level {level} masked={masked} {dtype}"
                check(out.shape == (BATCH, res, res, heads * HEAD_DIM),
                      f"{what}: output {tuple(out.shape)}")
                err, mean_err, fault = hold(what, out, ref, plain, bias,
                                            mask)
                errs[dtype].append((err, mean_err, fault))
                via_k1 = _k1_path(qkv, bias, mask, scale)
                err_k1 = (out.float() - via_k1.float()).abs().max().item()
                tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
                check(err_k1 < tol, f"{what}: max |kernel - K1 path| "
                                    f"{err_k1} (bar {tol})")
                if dtype != torch.bfloat16:
                    continue
                full = _sdpa_mask(bias, mask, BATCH * n_w, dtype)
                err_lib = (_sdpa_image_path(qkv, full, scale).float()
                           - ref.float()).abs().max().item()

                def kernel(qkv):
                    return wa.image_attention_cuda(qkv, bias, mask, scale,
                                                   WINDOW)

                def library(qkv):
                    return _sdpa_image_path(qkv, full, scale)

                copies = input_copies(qkv)
                t_kernel = device_ms(kernel, copies)
                t_plain = device_ms(lambda qkv: wa.image_attention_torch(
                    qkv, bias, mask, scale, WINDOW), copies)
                t_k1 = device_ms(lambda qkv: _k1_path(qkv, bias, mask,
                                                      scale), copies)
                t_lib = device_ms(library, copies)
                t_kernel_warm = device_ms(kernel, copies[:1])
                t_lib_warm = device_ms(library, copies[:1])
                del copies
                # qkv read once, out (a third of its size) written once,
                # bias and mask read once; the two products' operations
                moved = qkv.numel() * qkv.element_size() * 4 // 3 \
                    + bias.numel() * 4 \
                    + (0 if mask is None else mask.numel() * 4)
                ops = 4 * BATCH * n_w * heads * TOKENS * TOKENS * HEAD_DIM
                t_bytes = 1e3 * moved / HBM_BYTES_PER_S
                t_ops = 1e3 * ops / PEAK_OPS_PER_S[str(dtype)]
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                print(f"[k2] level {level} B={BATCH} R={res} "
                      f"C={heads * HEAD_DIM} H={heads} "
                      f"{'SW-MSA' if masked else 'W-MSA '} bf16, L2-cold: "
                      f"kernel_ms={t_kernel:.4f} plain_ms={t_plain:.4f} "
                      f"k1_path_ms={t_k1:.4f} "
                      f"library_ms(permute+SDPA+permute)={t_lib:.4f} "
                      f"bound_ms={bound:.4f} ({by}); warm: "
                      f"kernel_ms={t_kernel_warm:.4f} "
                      f"library_ms={t_lib_warm:.4f}; |kernel - plain| "
                      f"max={err:.3g} mean={mean_err:.3g} (a misaddressed "
                      f"table: mean >= {fault:.3g}), vs_k1_path="
                      f"{err_k1:.3g}, library_err={err_lib:.3g}; "
                      f"calls/forward={calls}", flush=True)
                per_forward["ms"] += calls * t_kernel
                per_forward["warm_ms"] += calls * t_kernel_warm
                per_forward["plain_ms"] += calls * t_plain
                per_forward["k1_path_ms"] += calls * t_k1
                per_forward["library_ms"] += calls * t_lib
                per_forward["library_warm_ms"] += calls * t_lib_warm
                per_forward["bound_ms"] += calls * bound
                per_forward["bytes_ms"] += calls * t_bytes
                per_forward["ops_ms"] += calls * t_ops
    print_errors("k2", errs)
    print(f"[k2] per bf16 forward (14 calls), L2-cold: kernel "
          f"{per_forward['ms']:.4f} ms (warm {per_forward['warm_ms']:.4f}), "
          f"K1 path {per_forward['k1_path_ms']:.4f} ms, plain "
          f"{per_forward['plain_ms']:.4f} ms, permute+SDPA+permute "
          f"{per_forward['library_ms']:.4f} ms (warm "
          f"{per_forward['library_warm_ms']:.4f}), bound "
          f"{per_forward['bound_ms']:.4f} ms", flush=True)

    # one backward through the autograd Function (kernel forward, backward
    # through autograd of the plain version) against autograd through the
    # plain version; TF32 off
    qkv = torch.randn(BATCH, 56, 56, 3 * 3 * HEAD_DIM,
                      generator=gen).cuda()
    bias, mask = _tables(0, 3, True, gen)
    g = torch.randn(BATCH, 56, 56, 3 * HEAD_DIM, generator=gen).cuda()
    grads = []
    for force in (None, "torch"):
        leaves = [t.clone().requires_grad_() for t in (qkv, bias, mask)]
        (wa.fused_image_window_attention(*leaves, scale, WINDOW, force=force)
         * g).sum().backward()
        grads.append([t.grad for t in leaves])
    grad_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    check(grad_err < 1e-3, f"K2 backward: max |Function - autograd| "
                           f"{grad_err}")
    print(f"[k2] backward max |Function - plain autograd| {grad_err:.3g}",
          flush=True)
    bound_by = "bytes" if per_forward["bytes_ms"] >= per_forward["ops_ms"] \
        else "operations"
    return per_forward, bound_by, max(e[0] for e in errs[torch.bfloat16])


def phase_small_vs_cpu():
    """The port's small Swin U-Net in float32: the card (kernel) against
    the CPU (plain version), the same weights, on the windows-layout path
    (K1) and on the image-layout path (K2)."""
    import numpy as np
    import torch

    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    cfg = swin_unet_224_config()
    arch = cfg["model"]["segmentation.models.UNet"]["architecture"]
    arch.update(channels=(8, 16, 32), depth=2)
    arch["basic_block"]["segmentation.models.blocks.SwinTransformerBlock"] \
        .update(img_size=112, embed_dim=8, num_heads_layers=(1, 2, 4))
    cd = ConfigDict(cfg)
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    model.init(seed=2)
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 112, 112, 3)).astype(np.float32))
    with torch.no_grad():
        ref = model.apply(x)
        model.module.cuda()
        for mode, kernel in (("off", wa.window_attention_cuda),
                             ("on", wa.image_attention_cuda)):
            ops.set_fused_image_mode(mode)
            kernel.launches = 0
            try:
                out = model.apply(x.cuda()).cpu()
            finally:
                ops.set_fused_image_mode("off")
            err = (out - ref).abs().max().item()
            check(out.shape == (2, 112, 112, 1) and err < 1e-4
                  and kernel.launches == 10,
                  f"small Swin U-Net f32, fused image mode {mode}: card vs "
                  f"CPU max |diff| {err}, {kernel.launches} launches")
            print(f"[small] f32 Swin U-Net 112x112, fused image mode {mode}"
                  f", card ({kernel.__name__}, {kernel.launches} launches) "
                  f"vs CPU (plain): max |diff| {err:.3g}", flush=True)


def phase_serve(tmp: Path):
    """Full-width swin_unet_224 bf16 serving through predict_from_config on
    the windows-layout path (K1), then with the attention pinned to the
    plain version, then on the image-layout path (K2).  Returns the K1 and
    K2 launches of their serving runs."""
    import numpy as np

    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model, swin
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.predict import predict_from_config
    from medsegpretrainimagenet_tpu_torch.train.checkpoint import (
        save_params_file)

    cd = ConfigDict(swin_unet_224_config())
    cd.expand()
    registry.fill_spec(cd, "model")
    model = registry.build(cd, key="model", wrapper=Model)
    n_params = model.get_num_params()
    check(n_params == 27_166_596, f"swin_unet_224 has {n_params} params")
    save_params_file(str(tmp / "w.pt"), model.init(seed=0))
    imgs = (np.random.default_rng(0).random((SERVE_IMAGES, 1, 224, 224))
            * 255).astype(np.uint8)
    np.save(tmp / "imgs.npy", imgs)

    def serve(out_name: str, path: str = "k1"):
        """*path*: "k1" (windows layout, K1), "plain" (windows layout,
        attention pinned to its plain version) or "k2" (image layout)."""
        core = swin.window_attention_core
        if path == "plain":
            swin.window_attention_core = functools.partial(core,
                                                           force="torch")
        ops.set_fused_image_mode("on" if path == "k2" else "off")
        try:
            return predict_from_config(
                ConfigDict(swin_unet_224_config()), str(tmp / "w.pt"),
                str(tmp / "imgs.npy"), str(tmp / out_name),
                batch_size=BATCH, mixed_precision=True, device="cuda")
        finally:
            swin.window_attention_core = core
            ops.set_fused_image_mode("off")

    def counted(path: str):
        """One serving run of *path* with both launch counts set to 0
        just before it; returns (stats, outputs, K1 launches, K2
        launches)."""
        wa.window_attention_cuda.launches = 0
        wa.image_attention_cuda.launches = 0
        stats = serve(f"{path}.npy", path)
        out = np.load(tmp / f"{path}.npy")
        check(out.shape == (SERVE_IMAGES, 224, 224, 1)
              and out.dtype == np.float32 and np.isfinite(out).all()
              and out.min() >= 0 and out.max() <= 1,
              f"serving output ({path}) {out.shape} {out.dtype} in "
              f"[{out.min()}, {out.max()}]")
        return (stats, out, wa.window_attention_cuda.launches,
                wa.image_attention_cuda.launches)

    forwards = -(-SERVE_IMAGES // BATCH)
    serve("warmup.npy")  # first calls: cuBLAS/cuDNN set-up, kernel load
    stats, out, k1_launches, k2_none = counted("k1")
    check(k1_launches == 14 * forwards and k2_none == 0,
          f"launches on the windows-layout serving path: K1 {k1_launches} "
          f"(want {14 * forwards}), K2 {k2_none} (want 0)")
    plain_stats, plain, k1_none, k2_none = counted("plain")
    check(k1_none == 0 and k2_none == 0, "the plain run launched a kernel")
    diff = float(np.abs(out - plain).max())
    check(diff < SERVE_TOL, f"serving outputs, kernel vs plain attention: "
                            f"max |diff| {diff} (bar {SERVE_TOL})")
    print(f"[serve] swin_unet_224 bf16, {SERVE_IMAGES} images, batch "
          f"{BATCH}: kernel {stats['images_per_sec']} images/s, plain "
          f"attention {plain_stats['images_per_sec']} images/s; K1 "
          f"launches {k1_launches} ({k1_launches // forwards} per forward); "
          f"max |kernel - plain| of the sigmoid outputs {diff:.3g} (bar "
          f"{SERVE_TOL})", flush=True)

    serve("warmup.npy", "k2")  # the image-layout path's own GEMM shapes
    fused_stats, fused, k1_none, k2_launches = counted("k2")
    check(k2_launches == 14 * forwards and k1_none == 0,
          f"launches on the image-layout serving path: K2 {k2_launches} "
          f"(want {14 * forwards}), K1 {k1_none} (want 0)")
    diff_k1 = float(np.abs(fused - out).max())
    diff_plain = float(np.abs(fused - plain).max())
    check(diff_k1 < SERVE_TOL and diff_plain < SERVE_TOL,
          f"serving outputs, image layout (K2) vs K1 path {diff_k1}, vs "
          f"plain attention {diff_plain} (bar {SERVE_TOL})")
    print(f"[serve] fused image layout: K2 {fused_stats['images_per_sec']} "
          f"images/s; K2 launches {k2_launches} ({k2_launches // forwards} "
          f"per forward), K1 launches {k1_none}; max |K2 path - K1 path| "
          f"{diff_k1:.3g}, max |K2 path - plain| {diff_plain:.3g} (bar "
          f"{SERVE_TOL})", flush=True)

    # one short run is at the mercy of the shared host: time the three
    # again in turns (plain, K1, K2, K2, K1, plain, twice), medians
    rates = {"plain": [], "k1": [], "k2": []}
    for path in ("plain", "k1", "k2", "k2", "k1", "plain") * 2:
        rates[path].append(serve("turn.npy", path)["images_per_sec"])
    for path, name in (("k1", "kernel (K1, windows layout)"),
                       ("k2", "fused image layout (K2)"),
                       ("plain", "plain attention")):
        print(f"[serve] in turns, {name}: median "
              f"{statistics.median(rates[path])} images/s of "
              f"{sorted(rates[path])}", flush=True)
    for path in ("k1", "k2"):
        profile_serving(functools.partial(serve, path=path), path,
                        SERVE_IMAGES / statistics.median(rates[path]))
    return k1_launches, k2_launches


#: kernel-name fragments -> the layer they belong to, for the breakdown
_KERNEL_GROUPS = (("image_attention", "K2 image attention"),
                  ("window_attention", "K1 window attention"),
                  ("gemm", "matmul (cuBLAS)"), ("xmma", "matmul (cuBLAS)"),
                  ("nvjet", "matmul (cuBLAS)"),
                  ("cutlass", "matmul (cuBLAS)"), ("conv", "conv (cuDNN)"),
                  ("layer_norm", "LayerNorm"), ("memcpy", "memcpy"),
                  ("catarray", "concat"), ("roll_cuda", "roll"),
                  ("elementwise", "elementwise (casts, adds, GELU, copies)"))


def profile_serving(serve, path: str, loop_seconds: float) -> None:
    """Where the serving time goes on *path*: one more predict call under
    torch.profiler, device time by layer and by kernel.  The model upload
    (pageable host-to-device copies) is set-up and left out; the device's
    busy share is its time per batch over the wall time per batch of the
    unprofiled runs of that path (*loop_seconds* for all batches,
    median)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        serve("profiled.npy")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total
               and "pageable" not in e.key.lower()]
    if not kernels:
        print(f"[profile {path}] device time not measured: the profiler "
              f"recorded no kernels", flush=True)
        return
    batches = -(-SERVE_IMAGES // BATCH)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / batches
    wall_ms = 1e3 * loop_seconds / batches
    print(f"[profile {path}] per batch of {BATCH}: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f} %), "
          f"{sum(e.count for e in kernels) // batches} kernel launches")
    groups = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for frag, g in _KERNEL_GROUPS if frag in name),
                     "other")
        groups[group] = groups.get(group, 0.0) \
            + e.device_time_total / 1e3 / batches
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile {path}]   {group}: {ms:.3f} ms/batch "
              f"({100 * ms / busy_ms:.1f} %)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
        print(f"[profile {path}]   {e.device_time_total / 1e3 / batches:7.3f} "
              f"ms/batch {e.count // batches:4d}x {e.key[:90]}")
    sys.stdout.flush()


def main() -> int:
    if not (ROOT / "medsegpretrainimagenet_tpu_torch").is_dir():
        fail("run from a checkout: the package medsegpretrainimagenet_tpu_"
             "torch is not beside this script")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    card = card_line()
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase_build()
    k1, k1_bound_by, k1_err = phase_k1()
    k2, k2_bound_by, k2_err = phase_k2()
    with tempfile.TemporaryDirectory() as tmp:
        phase_small_vs_cpu()
        k1_launches, k2_launches = phase_serve(Path(tmp))

    # per kernel: the 14 calls of one bf16 forward at batch 24, summed,
    # L2-cold (warm_ms: the same calls on warm inputs); launches from its
    # own serving run
    kernels = [{
        "name": "window_attention",
        "route": "cuda",
        "source": "medsegpretrainimagenet_tpu_torch/csrc/window_attention.cu",
        "replaces": "medsegpretrainimagenet_tpu/ops/window_attention.py:81",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1["ms"], "warm_ms": k1["warm_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1_bound_by,
        "library_ms": k1["library_ms"],
    }, {
        "name": "image_attention",
        "route": "cuda",
        "source": "medsegpretrainimagenet_tpu_torch/csrc/image_attention.cu",
        "replaces": "medsegpretrainimagenet_tpu/ops/window_attention.py:266",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2["ms"], "warm_ms": k2["warm_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2_bound_by,
        # the layout permutes around SDPA included: the same function
        "library_ms": k2["library_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
