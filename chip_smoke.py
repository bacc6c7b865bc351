#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (medsegpretrainimagenet_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``csrc/`` (one nvcc per source,
all at once) and counts the tensor-core instructions (HMMA; HGMMA, the
warpgroup's, in the backward kernels) of each kernel instance in its SASS,
beside ptxas's registers and spills: every instance, bf16 and float32
(split TF32), runs on the tensor cores, and one without either fails, as
does a bf16 backward instance with any HMMA (its five products are all
wgmma).  It holds each kernel against its plain PyTorch version on the
card at the shapes the serving path gives it: K1 (window attention,
windows layout) and K2 (the
image-layout path, which also holds against the K1 path on the same input),
on the max and the mean |kernel - plain|; the mean bar is checked to sit
far under what a dropped or misaddressed bias or mask would read.  Each is
timed L2-cold (the calls rotate over copies of the inputs that together
exceed twice the L2) and warm, beside its plain version, one PyTorch
library call and the bound.  ``[k1 bwd]`` and ``[k2 bwd]`` do the same
for the backward kernels at the shapes of one ``swin_224_train`` step (K2
also on the bands of rows of spatial sharding), the gradients bit-equal
on a second launch, and print each backward instance's registers, spills,
shared memory and warps resident per SM (twelve or more in bf16, eight in
float32), each launch's blocks against the card's slots, and the host
microseconds a bf16 call spends encoding its tensor maps.  (To time K1
and K2 against another checkout, see
``medsegpretrainimagenet_tpu_torch/ops/kernel_ab.py``.)  It drives the
full-width Swin U-Net 224 (``swin_unet_224``, random weights from a seed)
through the port's ``predict_from_config`` in bf16 on both paths, the
windows layout through K1 and the image layout through K2
(``set_fused_image_mode("on")``), checks that each went through its kernel,
and that their outputs agree with each other, with the plain attention and,
on a small input, with the CPU.  It times both paths in turns and profiles
one call of each.  Then ``[train]`` drives the port's U-Net training step:
a small float32 U-Net, three steps of two fragments on the card against
the same steps on the CPU; ``unet_256_train`` at full width in bf16
against the same port in float32 for three steps from the same weights,
with three injected faults that must read above the bars; then
``unet_256_train`` at full width (the JAX package's headline step: U-Net
64 -> 1024, 256 x 256, batch 16, bf16 compute, SGD with momentum, Dice
loss), built through the framework's own objects, timed, with its loss
falling on a fixed batch, its running statistics
moving and no host sync queued by the timed steps; it prints images/s, the
device's busy share and its time per step by kernel group, launches and
peak memory per step and the share of the operations bound, and runs one
turn with two fragments of 8.  ``[remat]`` steps ``unet_256_train`` from
the same weights with block rematerialisation off and then on
(``blocks.set_remat``, ``meta/technical/remat``): the two within
``[train bf16]``'s bars, every basic block under checkpoint, no host sync
in the timed steps, the peak memory lower with remat on, both step times
and peaks printed; and a small ResNet attention U-Net with remat on, card
against CPU, and with drop paths from the card's generator, remat on
against off.  ``[cli]`` then drives the port's experiment
CLI as a user runs it, ``python3 -m medsegpretrainimagenet_tpu_torch.cli
config.yaml`` in a process of its own, on a synthetic COVID-QU tree (512
training images of 256 x 256): the full-width CLI config for two epochs,
then a third under ``--continued``.  It checks the run files (every
``.pt`` loads into the model), the row counts of epoch_logs.csv and
batch_logs.csv, the columns, the backups, the loss falling and the val
Dice rising, and that the error envelope printed nothing; it prints the
epochs' images/s beside ``[train]``'s, the val and checkpoint times and the
device time per step.  In this process it counts the host syncs of
``run_epoch`` at two step counts, times host assembly and the copy to the
card per batch, profiles the device's busy share and runs the test
pass; ``[cli det]``: the --continued epoch runs under deterministic
algorithms and names any operation that has no deterministic CUDA
kernel.  ``[metrics]`` holds every metric
of the suite (HD95, AUROC and AP, the multiclass family) on one full-width
batch against the same port on the CPU, under sync debug mode "error" and
under deterministic algorithms, with its device ms and launches per update,
and steps ``unet_256_train`` with the COVID-QU reference metric set folded
into the step.  ``[cli acdc]`` trains the ACDC multiclass U-Net (the
full-width U-Net with a 4-class softmax head, multiclass Dice loss, the
multiclass Dice, Jaccard, HD95 and AUROC, the confusion-matrix export and
a profiler trace) through the CLI on a synthetic NIfTI tree, two epochs
and a third under ``--continued`` (the --continued runs and ``[cli
transfer]`` are not measured: no profiling, so no trace, and
no cuDNN autotuning).  ``[pretrain small]`` holds a
small float32 pretraining classifier (a ``FeedForwardModel`` of the U-Net
encoder, pooling, flatten and a Linear head) card against CPU over three
cross-entropy + AdamW steps; ``[pretrain]`` times
``unet_encoder_224_pretrain`` (the JAX package's pretraining headline: the
U-Net encoder 64 -> 1024 with a 1000-way head, 64 images of 224 x 224,
bf16) as ``[train]`` times its step, then the same step with the on-card
classification chain inside it; ``[cli pretrain]`` pretrains it through
the CLI for two epochs on a synthetic ImageNet store with the host chain
(RandomResizedCrop, flip, RandAugment, one-hot, MixupOrCutMix,
RandomErasing), and ``[cli transfer]`` trains the ``[cli]`` U-Net for one
epoch from that run's epoch-1 checkpoint, its encoder checked against the
checkpoint before the first step.  ``[robustness small]`` holds a small
transferability sweep over the paper's three encoder families (a narrow
U-Net encoder, a narrow ResNet, the Swin encoder) card against CPU with
TF32 off and the same jitter draws, and K1's float32 instance against its
plain version on the inputs the Swin encoder gives it; ``[robustness]``
runs ``robustness_224`` (the JAX package's ``tools/robustness_tpu.py``: 32
probes of 224 x 224, the U-Net encoder, ResNet-50 and the Swin encoder in
float32): each encoder's forward timed, the Swin encoder's K1 launches (and
K2's under ``set_fused_image_mode("on")``), its forward profiled by kernel
group (``[profile robustness swin]``), K1 and K2 in float32 timed against
plain, SDPA and the bound, the sweep in this process with its launches and
host syncs (and again on the K2 path, rows against the K1 path's), then
the sweep CLI in a process of its own with
``[cli pretrain]``'s encoder and reference-named ResNet-50 and Swin weight
files: 330 finite rows, margin-monotone, levels 4/4/3, the JAX CLI's
columns, every weight file loaded.  ``[swin train small]`` steps the small
float32 Swin U-Net on the card (its attention K1, then K2, under autograd:
the forward kernel and its backward kernel) against the CPU;
``[swin train]`` times ``swin_224_train`` (the JAX package's Swin
headline: swin_unet_224 at batch 24, bf16, stochastic depth 0.2, SGD with
momentum, Dice loss) in turns with its attention on K1, on the plain
version under autograd and on K2, checks 14 launches of the route's
forward and backward kernels a step, profiles it, times the attention of
one step forward and backward on each layout (the kernel pair against
the forward kernel with the plain recompute backward, plain autograd and
SDPA), and prints which of the two candidates for ``train=True`` is
faster; ``[ln half]`` turns on the half-output LayerNorms
(``blocks.set_ln_half_out``): the small Swin U-Net's bf16 steps card
against CPU on K1 and on K2 (each reading within twice that of the same
comparison with the switch off, or within ``[train bf16]``'s bar),
``swin_224_train`` on K1 timed and profiled beside ``[swin train]``'s K1
route (ms a step, busy ms, launches, the LayerNorm and copies-and-permutes
groups), every K1 and K2 call of one step on each route, forward and
backward, held against its plain version, and ``swin_unet_224``'s device
ms a batch served with the switch on and off on both paths;
``[resnet train]`` times the ResNet-50 attention U-Net's step (16 x 256 x
256, bf16); ``[cli swin]`` and ``[cli resnet]`` train both through the CLI
on synthetic COVID-QU trees, three epochs in one process, the encoder
grafted from reference-named weights, and
count K1's launches in a no-grad validation pass of the trained Swin
U-Net.  ``[blocks small]`` steps a small float32 U-Net of each block kind
of the residual zoo (ResNeXt, inverted bottleneck, ConvNeXt) with its
shortcut, layer scaling and stochastic depth (the drop paths fed in alike)
on the card against the CPU; ``[cli mixed]`` runs one epoch of a
``MixedDataset`` of two COVID-QU readers (lazy reloads, shuffled
switching, over- and under-balancing) through the CLI, its stateful loads
kept serial; ``[cli idrid]`` trains the paper's IDRiD U-Net (the MA task,
448 -> 224 crops) through the CLI on a synthetic tree of 2848 x 4288
fundus images, three epochs in one process, with the
reader's host seconds per image, the crops it keeps and drops, the host
assembly per batch, the epochs' images/s and the process's peak memory.
``[export]`` exports ``swin_unet_224`` in bf16 with a symbolic batch
through ``export.export_from_config``, on the windows layout and under
``set_fused_image_mode("on")``: each artifact's graph holds 14 nodes of
its registered operator (K1's or K2's) and no softmax, one forward of the
loaded artifact launches the kernel 14 times, its outputs equal
``predict_from_config``'s, and it is timed in turns against it; the
float32 U-Net's artifact equals its module.  ``[ddp]`` runs a one-epoch
COVID-QU CLI under ``torchrun --nproc_per_node 1`` on NCCL (the
data-parallel path: shards, the global BatchNorm, gathered outputs,
summed gradients) against the plain CLI, and times and profiles the
data-parallel step beside ``[train]``.  ``[tp]``, ``[sp]`` and ``[pp]``
run in one ``torchrun --nproc_per_node 2`` launch whose two ranks share
the card over gloo (asked for by name: NCCL refuses two ranks on one
device), each held against one process on the card in float32 with TF32
off: ``unet_256_train`` and ``swin_224_train`` with their wide layers
column-parallel (data x model 1 x 2; K1 launched 14 times per Swin step on
the gathered qkv), ``unet_256_train`` on two bands of 128 rows with halo
exchanges (data x spatial 1 x 2), and two DoubleSwin stages of
``swin_224``'s first level in a GPipe pipeline (data x pipe 1 x 2, K1
inside the stages) in float32 and bf16; their ms are a correctness run's,
not a speed.  ``python3 chip_smoke.py --only parallel`` runs the parallel
phases alone on four cards, one rank per card over NCCL: ``[tp]``,
``[sp]``, ``[pp]`` at 2 x 2 and 1 x 4 (the first two profiled), then the
CLI under ``torchrun --nproc_per_node 4`` with data parallelism (and its
step timed), with ``tensor_parallel: 2`` and with ``spatial_sharding: 2``
against the plain CLI; with fewer cards it exits non-zero naming the
count.
Any failure exits non-zero.  Without a CUDA
card, or without the package beside it, it exits non-zero and prints no
result.  It imports nothing of JAX.

The last lines are the card's name and power limit, a JSON line with each
kernel's launches, error and times (K1 and K2 in bf16 per serving forward,
and in float32 per Swin encoder forward of ``robustness_224``; both
entries also carry their launches and their forward and backward pair
per step of ``swin_224_train`` (also with the half-output LayerNorms)
and their launches in one forward of
their exported artifact; K1's also per step of ``swin_224_train`` under
tensor parallelism and per tick of the pipeline; the backward kernels,
bf16 and float32, per step of ``swin_224_train``: ``[k1 bwd]``,
``[k2 bwd]``), and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import re
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
#: [k2]'s band instances: swin_224_train's level 0 at TP_SWIN_BATCH, the
#: batch of [sp]'s Swin step
K2_BAND_BATCH = 8
#: bars on the mean |kernel - plain|.  A sound bf16 kernel reads about 1e-7
#: (a bf16 step on a few outputs); one that drops the bias or reads another
#: head's bias or another window's mask reads 1e-3 or more, under the max
#: bar all the same (phase_k1 and phase_k2 measure both and check that
#: the bar sits between them)
MEAN_TOL = {"torch.bfloat16": 1e-5, "torch.float32": 1e-6}
#: how far under the least fault reading the mean bar must sit
FAULT_MARGIN = 10
SERVE_IMAGES, SERVE_TOL = 96, 2e-2
#: unet_256_train: batch, image side, steps per timed turn, timed turns
#: (every timed step of the script takes TURNS turns: 5 until PR 12, 3
#: since the parallel phases came in)
TRAIN_BATCH, TRAIN_SIZE, TURN_STEPS, TURNS = 16, 256, 10, 3
#: card against CPU, the small float32 step (TF32 off)
TRAIN_TOL = 1e-4
#: unet_256_train in bf16 against the same port in float32 (TF32 off),
#: BF16_STEPS steps from the same weights on the same batch: bars on the
#: relative |bf16 - f32| of the loss, of the gradient norm, and of the
#: change over the steps of the worst parameter leaf and of the worst
#: running statistic.  Conv biases are held through the loss and the norm
#: only: in front of a BatchNorm (and the stem's, but at the borders)
#: their gradient is rounding noise.  On an H100 with seeds 0 to 2 a sound
#: step read at most 1.67e-3, 1.27e-2, 0.391 and 0.0132; the faults that
#: phase_train_bf16 injects read at least 0.0272 in running statistics
#: (statistics taken in bf16), 0.224 there (conv bias dropped), and
#: 5.65e-3 in loss and 0.906 in parameters (up-conv padding on the wrong
#: side).  The gradient norm separates no fault from bf16 rounding.  Each
#: fault must read BF16_FAULT_MARGIN times a bar or more.
BF16_STEPS = 3
BF16_TRAIN_TOL = {"loss": 2.5e-3, "gradient norm": 3e-2, "parameters": 0.55,
                  "running statistics": 0.017}
BF16_FAULT_MARGIN = 1.5


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def timed(name: str, fn, *args):
    """Run a phase and print its wall time as ``[time] name: s``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


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


def _ptxas_report(log: str) -> dict:
    """{entry function: "N registers, S bytes spill stores, L bytes spill
    loads"} from nvcc's ``-Xptxas -v`` log."""
    report, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = entry.group(1)
            report[current] = {}
        elif current is not None and "spill" in line:
            report[current]["spills"] = ", ".join(
                p.strip() for p in line.split(",")[1:])
        elif current is not None and "registers" in line:
            report[current]["registers"] = re.search(
                r"(\d+) registers", line).group(1)
    return {k: f"{v.get('registers', '?')} registers, "
               f"{v.get('spills', 'spills not reported')}"
            for k, v in report.items()}


#: the kernel libraries, csrc/<name>.cu: the forwards and their backwards
KERNEL_LIBRARIES = {"window_attention", "image_attention",
                    "window_attention_bwd", "image_attention_bwd"}

#: [build]'s report per kernel instance (``window_attention_bwd<f32, DP
#: 32>``): ptxas's registers and spills
PTXAS = {}


def phase_build():
    """Build every kernel; per kernel instance its HMMA and HGMMA counts in
    the SASS (every attention instance, bf16 and float32, forward and
    backward, runs on the tensor cores: one without either fails, and the
    bf16 backward instances take HGMMA only; the backward's partial sum,
    tile::sum_partials, has none) and ptxas's registers and spills."""
    from medsegpretrainimagenet_tpu_torch.ops import _build
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import (
        instance_label, opcodes, parse_sass)

    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    check(set(built) >= KERNEL_LIBRARIES, f"kernels built: {sorted(built)}")
    cuobjdump = str(Path(_build.nvcc()).parent / "cuobjdump")
    # one cuobjdump per library, all started together
    dumps = {name: subprocess.Popen(
        [cuobjdump, "-sass", info["path"]], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, info in built.items()}
    for name, info in built.items():
        print(f"[build] {name}: {info['seconds']:.2f} s"
              f"{' (cached)' if info['cached'] else ''}")
        ptxas = _ptxas_report(info["log"])
        sass, err = dumps[name].communicate(timeout=120)
        check(dumps[name].returncode == 0,
              f"cuobjdump -sass {info['path']}: {err.strip()}")
        instances = []
        for symbol, (code, _) in parse_sass(sass).items():
            ops = opcodes(code)
            hmma = sum(op.startswith("HMMA") for op in ops)
            hgmma = sum(op.startswith("HGMMA") for op in ops)
            label = instance_label(symbol)
            instances.append(label)
            PTXAS[label] = ptxas.get(symbol, "no ptxas report")
            print(f"[build]   {label}: {hmma} HMMA, {hgmma} HGMMA, "
                  f"{PTXAS[label]}")
            check(hmma + hgmma > 0 or "sum_partials" in symbol,
                  f"{label} ({symbol}): a kernel instance without "
                  f"tensor-core instructions")
            if label.startswith(f"{name}<bf16") and name.endswith("_bwd"):
                check(hgmma > 0 and hmma == 0,
                      f"{label}: {hmma} HMMA and {hgmma} HGMMA, where every "
                      f"product of the bf16 backward is a wgmma")
        for dtype in ("bf16", "f32"):
            check(sum(f"<{dtype}," in i for i in instances) == 4,
                  f"{name}: want the four {dtype} instances (D padded to 16,"
                  f" 32, 48, 64), got {instances}")
    print(f"[build] all kernels: {seconds:.2f} s", flush=True)


def _k1_inputs(level, heads, n_w, masked, dtype, generator, batch=BATCH):
    import torch

    windows = batch * n_w
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

    # one backward through the registered operator (the forward kernel and
    # the backward kernel) against autograd through the plain version; the
    # same float32 math in another order, TF32 off
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

    b, rows, cols, c3 = qkv.shape
    heads, c = bias.shape[0], c3 // 3
    windows = window_partition(qkv, WINDOW).reshape(-1, TOKENS, 3, heads,
                                                    c // heads)
    q, k, v = windows.permute(2, 0, 3, 1, 4).contiguous()
    out = wa.window_attention_cuda(q, k, v, bias, mask, scale)
    out = out.transpose(1, 2).reshape(-1, WINDOW, WINDOW, c)
    return window_reverse(out, WINDOW, rows, cols)


def _sdpa_image_path(qkv, full, scale):
    """The library yardstick for K2: the image-to-windows layout permute of
    qkv, SDPA with bias and mask folded into *full*, the permute back."""
    import torch.nn.functional as F

    b, rows, cols, c3 = qkv.shape
    heads = full.shape[1]
    n_wr, n_wc, d = rows // WINDOW, cols // WINDOW, c3 // 3 // heads
    t = qkv.reshape(b, n_wr, WINDOW, n_wc, WINDOW, 3, heads, d)
    t = t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, heads, TOKENS, d)
    out = F.scaled_dot_product_attention(t[0], t[1], t[2], attn_mask=full,
                                         scale=scale)
    out = out.reshape(b, n_wr, n_wc, heads, WINDOW, WINDOW, d)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, rows, cols,
                                                    c3 // 3)


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
    bands = _k2_bands(gen, scale, errs)
    print_errors("k2", errs)
    print(f"[k2] per bf16 forward (14 calls), L2-cold: kernel "
          f"{per_forward['ms']:.4f} ms (warm {per_forward['warm_ms']:.4f}), "
          f"K1 path {per_forward['k1_path_ms']:.4f} ms, plain "
          f"{per_forward['plain_ms']:.4f} ms, permute+SDPA+permute "
          f"{per_forward['library_ms']:.4f} ms (warm "
          f"{per_forward['library_warm_ms']:.4f}), bound "
          f"{per_forward['bound_ms']:.4f} ms", flush=True)

    # one backward through the registered operator (the forward kernel and
    # the backward kernel, in the image layout) against autograd through
    # the plain version; TF32 off
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
    return per_forward, bound_by, max(e[0] for e in errs[torch.bfloat16]), \
        bands


def _k2_bands(gen, scale, errs) -> list:
    """K2 on bands of rows (spatial sharding of swin_224_train's level 0,
    K2_BAND_BATCH x 56 x 56 tokens, 3 heads): the 28 x 56 bands of data x
    spatial 1 x 2 and the 14 x 56 bands of 1 x 4, SW-MSA with the last
    band's rows of the shift mask (the band whose windows the wrap
    reaches), bf16 and float32, each held against the plain version on the
    same band and timed L2-cold beside the square 56 x 56 instance at the
    same batch.  Returns one reading per shape and dtype, square included
    (the kernels line lists them)."""
    import torch

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import (
        device_ms, input_copies)

    heads, full_rows = 3, 56
    _, whole_mask = _tables(0, heads, True, gen)
    readings = []
    for bands in (1, 2, 4):
        rows = full_rows // bands
        n_wb = (rows // WINDOW) * (full_rows // WINDOW)
        mask = whole_mask[(bands - 1) * n_wb:].contiguous()
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(K2_BAND_BATCH, rows, full_rows,
                              3 * heads * HEAD_DIM,
                              generator=gen).to("cuda", dtype)
            bias, _ = _tables(0, heads, False, gen)
            out = wa.image_attention_cuda(qkv, bias, mask, scale, WINDOW)
            what = (f"K2 band {rows} x {full_rows} of {bands} "
                    f"({K2_BAND_BATCH} images) {dtype}")
            check(out.shape == (K2_BAND_BATCH, rows, full_rows,
                                heads * HEAD_DIM),
                  f"{what}: output {tuple(out.shape)}")

            def plain(bias, mask):
                return wa.image_attention_torch(qkv, bias, mask, scale,
                                                WINDOW)

            err, mean_err, fault = hold(what, out, plain(bias, mask), plain,
                                        bias, mask)
            errs[dtype].append((err, mean_err, fault))
            via_k1 = _k1_path(qkv, bias, mask, scale)
            err_k1 = (out.float() - via_k1.float()).abs().max().item()
            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            check(err_k1 < tol, f"{what}: max |kernel - K1 path| {err_k1} "
                                f"(bar {tol})")
            full = _sdpa_mask(bias, mask, K2_BAND_BATCH * n_wb, dtype)
            copies = input_copies(qkv)
            t_kernel = device_ms(lambda qkv: wa.image_attention_cuda(
                qkv, bias, mask, scale, WINDOW), copies)
            t_plain = device_ms(lambda qkv: wa.image_attention_torch(
                qkv, bias, mask, scale, WINDOW), copies)
            t_lib = device_ms(lambda qkv: _sdpa_image_path(qkv, full, scale),
                              copies)
            del copies
            moved = qkv.numel() * qkv.element_size() * 4 // 3 \
                + bias.numel() * 4 + mask.numel() * 4
            ops = 4 * K2_BAND_BATCH * n_wb * heads * TOKENS * TOKENS \
                * HEAD_DIM
            t_bytes = 1e3 * moved / HBM_BYTES_PER_S
            t_ops = 1e3 * ops / PEAK_OPS_PER_S[str(dtype)]
            reading = {
                "shape": [K2_BAND_BATCH, rows, full_rows, 3 * heads
                          * HEAD_DIM], "bands": bands,
                "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            readings.append(reading)
            square = next((r["ms"] for r in readings if r["bands"] == 1
                           and r["dtype"] == reading["dtype"]), t_kernel)
            print(f"[k2 band] {K2_BAND_BATCH} x {rows} x {full_rows} x "
                  f"{3 * heads * HEAD_DIM} ({bands} band{'s' * (bands > 1)}"
                  f" of 56 rows, mask rows {(bands - 1) * n_wb} to "
                  f"{bands * n_wb - 1}) {reading['dtype']}, L2-cold: "
                  f"kernel_ms={t_kernel:.4f} (the square 56 x 56 at this "
                  f"batch: {square:.4f}; per row of windows "
                  f"{t_kernel * bands / square:.3f} of its) plain_ms="
                  f"{t_plain:.4f} library_ms(permute+SDPA+permute)="
                  f"{t_lib:.4f} bound_ms={reading['bound_ms']:.4f} "
                  f"({reading['bound_by']}); |kernel - plain| max={err:.3g} "
                  f"mean={mean_err:.3g} (a misaddressed table: mean >= "
                  f"{fault:.3g}), vs_k1_path={err_k1:.3g}", flush=True)
    return readings


#: bars on dbias and dmask, each relative to its largest magnitude: the
#: float32 bars in both dtypes (dS, which they sum over windows, is
#: float32 in both)
TABLE_TOL, TABLE_MEAN_TOL = F32_TOL, MEAN_TOL["torch.float32"]


def hold_grads(what: str, got, want, names, plain):
    """Hold a backward kernel's gradients *got* against its plain
    version's *want* (tuples named by *names*): the inputs' gradients on
    the max and the mean |kernel - plain| under the dtype's bars (the mean
    over all their elements), dbias and dmask relative to their largest
    magnitude under TABLE_TOL and TABLE_MEAN_TOL.  Then, as :func:`hold`,
    check that the mean bar would catch a kernel that addressed its tables
    wrongly: the plain gradients recomputed by ``plain(bias, mask)`` with
    the bias dropped, the next head's bias and the next window's mask must
    each read at least FAULT_MARGIN times the bar.  Returns (max, mean,
    the worst table reading, the least fault reading)."""
    import torch

    dtype = got[0].dtype
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    mean_tol = MEAN_TOL[str(dtype)]
    inputs = [i for i, name in enumerate(names)
              if name not in ("dbias", "dmask")]

    def reading(a, b):
        diffs = [(a[i].float() - b[i].float()).abs() for i in inputs]
        return (max(d.max().item() for d in diffs),
                sum(d.sum().item() for d in diffs)
                / sum(d.numel() for d in diffs))

    err, mean_err = reading(got, want)
    table = 0.0
    for name, a, b in zip(names, got, want):
        check((a is None) == (b is None), f"{what}: {name} is missing")
        if a is not None and name in ("dbias", "dmask"):
            rel = (a - b).abs() / b.abs().max()
            check(rel.max().item() < TABLE_TOL
                  and rel.mean().item() < TABLE_MEAN_TOL,
                  f"{what}: {name} |kernel - plain| relative max "
                  f"{rel.max().item()}, mean {rel.mean().item()} (bars "
                  f"{TABLE_TOL}, {TABLE_MEAN_TOL})")
            table = max(table, rel.max().item())
    check(err < tol and mean_err < mean_tol
          and all(torch.isfinite(got[i]).all().item() for i in inputs),
          f"{what}: |kernel - plain| max {err} (bar {tol}), mean "
          f"{mean_err} (bar {mean_tol})")
    bias, mask = plain.tables
    faults = [(torch.zeros_like(bias), mask), (bias.roll(1, 0), mask)]
    if mask is not None:
        faults.append((bias, mask.roll(1, 0)))
    fault = min(reading(plain(b, m), want)[1] for b, m in faults)
    check(fault > FAULT_MARGIN * mean_tol,
          f"{what}: a kernel with a misaddressed table would read a mean "
          f"|kernel - plain| of {fault}, too close to the bar {mean_tol}")
    return err, mean_err, table, fault


def phase_bwd():
    """[k1 bwd] and [k2 bwd]: each backward kernel's instance at N 49, D
    32 (ptxas's registers and spills, shared memory a block, blocks and
    warps resident per SM: at least twelve warps in bf16, eight in
    float32); per shape the launch's blocks against the card's slots (SMs
    x blocks an SM), and in bf16 the host microseconds a call spends
    encoding its tensor maps; each kernel against its plain version at
    every level shape of one swin_224_train step (batch 24, W-MSA and
    SW-MSA, dmask asked for under SW-MSA), bf16 and float32, and K2's on
    the [k2 band] bands (28 x 56 and 14 x 56 of 56 at batch 8, the last
    band's mask rows); bit-equal gradients on a second launch;
    times per shape (the backward alone, L2-cold, dbias asked for as in
    training) beside the plain backward, the library (SDPA's backward,
    for K2 with its layout permutes) and the bound, summed per step.
    Returns per kernel and dtype the step's sums and the worst reading."""
    import torch
    import torch.nn.functional as F

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import (
        device_ms, input_copies)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(11)
    scale = HEAD_DIM ** -0.5
    out = {}
    for kernel in ("k1", "k2"):
        for dtype in (torch.bfloat16, torch.float32):
            out[kernel, str(dtype)] = {
                "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "max_abs_err": 0.0, "table_err": 0.0}
    # each instance at swin_unet_224's shapes (N 49, D 32, masked): its
    # registers and spills, shared memory a block, blocks and warps per
    # SM; the bf16 instances hold twelve warps an SM (three blocks), the
    # float32 ones eight (two)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, name in (("k1", "window_attention"),
                         ("k2", "image_attention")):
        for dtype, label in ((torch.bfloat16, "bf16"),
                             (torch.float32, "f32")):
            smem, blocks = wa.backward_residency(name, dtype, TOKENS,
                                                 HEAD_DIM, True)
            instance = f"{name}_bwd<{label}, DP {HEAD_DIM}>"
            print(f"[{kernel} bwd] {instance}: "
                  f"{PTXAS.get(instance, 'no ptxas report')}, {smem} bytes "
                  f"of shared memory a block, {blocks} blocks ({4 * blocks} "
                  f"warps) resident per SM", flush=True)
            out[kernel, str(dtype)].update(smem_bytes=smem,
                                           blocks_per_sm=blocks)
            least = 12 if dtype == torch.bfloat16 else 8
            check(4 * blocks >= least,
                  f"[{kernel} bwd] {instance}: {4 * blocks} warps per SM, "
                  f"under {least}")
    cases = [(level, heads, n_w, masked, n_masked if masked else n_plain, 1)
             for level, heads, n_w, n_masked, n_plain in LEVELS
             for masked in (False, True) if not masked or n_masked]
    # K2 alone: level 0 on two and on four bands of rows, as [k2 band]
    bands = [(0, 3, 64, True, 0, b) for b in (2, 4)]
    for kernel in ("k1", "k2"):
        for level, heads, n_w, masked, calls, band in \
                cases + (bands if kernel == "k2" else []):
            res = 56 // 2 ** level
            rows, batch = res // band, BATCH if band == 1 else K2_BAND_BATCH
            n_wb = (rows // WINDOW) * (res // WINDOW)
            for dtype in (torch.bfloat16, torch.float32):
                if kernel == "k1":
                    q, k, v, bias, mask = _k1_inputs(level, heads, n_w,
                                                     masked, dtype, gen)
                    g = torch.randn(q.shape, generator=gen).to("cuda", dtype)
                    operands, names = (q, k, v, g), ("dq", "dk", "dv",
                                                     "dbias", "dmask")
                    elements = 4 * q.numel()  # of q, k, v and g

                    def cuda(*ops, bias=bias, mask=mask, **flags):
                        q, k, v, g = ops
                        return wa.window_attention_backward_cuda(
                            q, k, v, bias, mask, scale, g, **flags)

                    def plain(bias, mask, ops=operands):
                        q, k, v, g = ops
                        return wa.window_attention_backward(
                            q, k, v, bias, mask, scale, g)
                else:
                    bias, whole = _tables(level, heads, masked, gen)
                    mask = None if whole is None \
                        else whole[len(whole) - n_wb:].contiguous()
                    c = heads * HEAD_DIM
                    qkv = torch.randn(batch, rows, res, 3 * c,
                                      generator=gen).to("cuda", dtype)
                    g = torch.randn(batch, rows, res, c,
                                    generator=gen).to("cuda", dtype)
                    operands, names = (qkv, g), ("dqkv", "dbias", "dmask")
                    elements = 4 * qkv.numel() // 3

                    def cuda(*ops, bias=bias, mask=mask, **flags):
                        qkv, g = ops
                        return wa.image_attention_backward_cuda(
                            qkv, bias, mask, scale, WINDOW, g, **flags)

                    def plain(bias, mask, ops=operands):
                        qkv, g = ops
                        return wa.image_attention_backward(
                            qkv, bias, mask, scale, WINDOW, g)
                plain.tables = (bias, mask)
                # the launch's grid (its partial tiles) against the card's
                # slots, and in bf16 the host's time to encode the maps
                if kernel == "k1":
                    grid = (q.shape[0], heads, TOKENS, HEAD_DIM, n_w,
                            int(masked))
                    maps = operands
                else:
                    grid = (batch, rows, res, c, heads, WINDOW, int(masked))
                    maps = (qkv, g, heads, WINDOW)
                name = "window_attention" if kernel == "k1" \
                    else "image_attention"
                blocks = wa._grad_entry(name, dtype, tiles=True)(*grid)
                slots = sms * out[kernel, str(dtype)]["blocks_per_sm"]
                encode = f", {wa.backward_map_us(name, *maps):.3f} us of " \
                    f"host time a call to encode its tensor maps" \
                    if dtype == torch.bfloat16 else ""
                got = cuda(*operands)
                again = cuda(*operands)
                torch.cuda.synchronize()
                check(all((a is None and b is None) or torch.equal(a, b)
                          for a, b in zip(got, again)),
                      f"[{kernel} bwd] gradients differ between two "
                      f"launches on the same inputs")
                shape = (f"level {level} {'SW-MSA' if masked else 'W-MSA '}"
                         if band == 1 else
                         f"band {rows} x {res} of {band}")
                what = f"[{kernel} bwd] {shape} {dtype}"
                err, mean_err, table, fault = hold_grads(
                    what, got, plain(bias, mask), names, plain)
                acc = out[kernel, str(dtype)]
                acc["max_abs_err"] = max(acc["max_abs_err"], err)
                acc["table_err"] = max(acc["table_err"], table)
                # timed as training asks: dbias, no dmask (the shift mask
                # is a buffer)
                copies = input_copies(*operands)
                t_kernel = device_ms(lambda *ops: cuda(
                    *ops, bias_grad=True, mask_grad=False), copies)
                t_plain = device_ms(lambda *ops: plain(bias, mask, ops),
                                    copies)
                b_req = bias.clone().requires_grad_()
                recorded = []
                for ops in copies:
                    leaves = [t.clone().requires_grad_() for t in ops[:-1]]
                    full = _sdpa_mask(b_req, mask, batch * n_wb, dtype)
                    if kernel == "k1":
                        y = F.scaled_dot_product_attention(
                            *leaves, attn_mask=full, scale=scale)
                    else:
                        y = _sdpa_image_path(leaves[0], full, scale)
                    recorded.append((y, (*leaves, b_req), ops[-1]))
                # the library yardstick: autograd's backward of a recorded
                # SDPA forward, kept for the next call
                t_lib = device_ms(lambda y, inputs, g: torch.autograd.grad(
                    y, inputs, g, retain_graph=True), recorded,
                    host_bound=True)
                del copies, recorded
                # q, k, v, g, bias and mask read once, dq, dk, dv and
                # dbias written once; five products of 2 N^2 D a pair (S,
                # dP, dV, dQ, dK)
                moved = (7 * elements // 4) * operands[0].element_size() \
                    + 2 * bias.numel() * 4 \
                    + (0 if mask is None else mask.numel() * 4)
                pairs = elements // 4 // HEAD_DIM // TOKENS
                t_bytes = 1e3 * moved / HBM_BYTES_PER_S
                t_ops = 1e3 * 10 * pairs * TOKENS * TOKENS * HEAD_DIM \
                    / PEAK_OPS_PER_S[str(dtype)]
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                print(f"{what}, L2-cold: kernel_ms={t_kernel:.4f} "
                      f"plain_ms={t_plain:.4f} library_ms(SDPA backward"
                      f"{'' if kernel == 'k1' else ' + permutes'})="
                      f"{t_lib:.4f} bound_ms={bound:.4f} ({by}); "
                      f"|kernel - plain| max={err:.3g} mean={mean_err:.3g} "
                      f"(a misaddressed table: mean >= {fault:.3g}), dbias"
                      f"{', dmask' if mask is not None else ''} relative max "
                      f"{table:.3g}; bit-equal twice; calls/step={calls}; "
                      f"{blocks} blocks of {slots} slots ({sms} SMs x "
                      f"{slots // sms}){encode}",
                      flush=True)
                for key, t in (("ms", t_kernel), ("plain_ms", t_plain),
                               ("library_ms", t_lib), ("bound_ms", bound),
                               ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
                    acc[key] += calls * t
    for (kernel, dtype), acc in out.items():
        acc["bound_by"] = "bytes" if acc["bytes_ms"] >= acc["ops_ms"] \
            else "operations"
        print(f"[{kernel} bwd] per {dtype.split('.')[-1]} step of "
              f"swin_224_train (14 calls), L2-cold: kernel "
              f"{acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, SDPA "
              f"backward {acc['library_ms']:.4f} ms, bound "
              f"{acc['bound_ms']:.4f} ms ({acc['bound_by']}), "
              f"{100 * acc['bound_ms'] / acc['ms']:.1f} % of it; worst max "
              f"|kernel - plain| {acc['max_abs_err']:.3g}, dbias and dmask "
              f"relative {acc['table_err']:.3g}", flush=True)
    return out


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
    # again in turns (plain, K1, K2, K2, K1, plain), medians
    rates = {"plain": [], "k1": [], "k2": []}
    for path in ("plain", "k1", "k2", "k2", "k1", "plain"):
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


#: [export]: the two swin_unet_224 artifacts' operator: (fused image
#: mode, operator, its launch counter's name, the other counter's name)
EXPORT_PATHS = (("off", "window_attention", "window_attention_cuda",
                 "image_attention_cuda"),
                ("on", "image_attention", "image_attention_cuda",
                 "window_attention_cuda"))
#: [export]: the U-Net artifact in float32 against its module
EXPORT_F32_TOL = 1e-5


def phase_export(tmp: Path) -> dict:
    """[export]: swin_unet_224 in bf16 (the [serve] weights and images)
    through ``export.export_from_config`` with a symbolic batch, on the
    windows layout and under ``set_fused_image_mode("on")``.  Each
    artifact's graph holds 14 nodes of its attention operator and no
    softmax (nothing falls back to the plain version); one forward of the
    loaded artifact at batch BATCH launches the kernel 14 times; its
    outputs equal [serve]'s eager ones (predict_from_config) within
    SERVE_TOL; its images/s is timed in turns against predict_from_config.
    Then the full-width U-Net exported in float32 against its module.
    Returns {operator: {"launches", ...}}."""
    import numpy as np
    import torch

    from medsegpretrainimagenet_tpu_torch import export, ops
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.predict import predict_from_config

    imgs = np.load(tmp / "imgs.npy")

    @torch.inference_mode()
    def artifact_serve(served):
        """The artifact over all SERVE_IMAGES in batches of BATCH, fed as
        predict_from_config feeds its module: under inference mode, the
        channel repeat on the host, uint8 through pinned memory, float/255
        on the card; one read-back at the end.  Returns (images/s,
        outputs)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for lo in range(0, SERVE_IMAGES, BATCH):
            x = torch.from_numpy(np.repeat(
                imgs[lo:lo + BATCH].transpose(0, 2, 3, 1), 3, axis=-1))
            x = x.pin_memory().cuda(non_blocking=True).float().div(255.0)
            outs.append(served(x).float())
        out = torch.cat(outs).cpu().numpy()
        return SERVE_IMAGES / (time.perf_counter() - t0), out

    def eager_serve(mode):
        ops.set_fused_image_mode(mode)
        try:
            return predict_from_config(
                ConfigDict(swin_unet_224_config()), str(tmp / "w.pt"),
                str(tmp / "imgs.npy"), str(tmp / "eager.npy"),
                batch_size=BATCH, mixed_precision=True,
                device="cuda")["images_per_sec"]
        finally:
            ops.set_fused_image_mode("off")

    results = {}
    for mode, op, counter, other in EXPORT_PATHS:
        path = tmp / f"swin_{op}.pt2"
        ops.set_fused_image_mode(mode)
        try:
            stats = export.export_from_config(
                ConfigDict(swin_unet_224_config()), str(tmp / "w.pt"),
                str(path), image_size=224, channels=3, mixed_precision=True,
                device="cuda")
        finally:
            ops.set_fused_image_mode("off")
        check(stats["out_avals"] == ["bfloat16[b,224,224,1]"]
              and stats["platforms"] == ["cuda"],
              f"[export] {op}: stats {stats}")
        targets = [str(n.target) for n in torch.export.load(
            str(path)).graph.nodes if n.op == "call_function"]
        nodes = targets.count(f"medseg_torch.{op}.default")
        others = sum("medseg_torch" in t for t in targets) - nodes
        softmax = sum("softmax" in t for t in targets)
        check(nodes == 14 and others == 0 and softmax == 0,
              f"[export] {op} artifact: {nodes} nodes of its operator (want "
              f"14), {others} of the other, {softmax} softmax")
        served = export.load_exported(str(path))
        x = torch.from_numpy(np.repeat(imgs[:BATCH].transpose(0, 2, 3, 1),
                                       3, axis=-1)).cuda().float() / 255.0
        served(x)  # first call: cuBLAS set-up for the artifact's shapes
        torch.cuda.synchronize()
        wa.window_attention_cuda.launches = 0
        wa.image_attention_cuda.launches = 0
        served(x)
        torch.cuda.synchronize()
        launches = getattr(wa, counter).launches
        stray = getattr(wa, other).launches
        check(launches == 14 and stray == 0,
              f"[export] one forward of the {op} artifact launched "
              f"{launches} (want 14), the other kernel {stray}")
        _, got = artifact_serve(served)
        want = np.load(tmp / ("k1.npy" if mode == "off" else "k2.npy"))
        diff = float(np.abs(got - want).max())
        check(got.shape == want.shape and np.isfinite(got).all()
              and diff < SERVE_TOL,
              f"[export] {op} artifact vs predict's eager forward: shape "
              f"{got.shape}, max |diff| {diff} (bar {SERVE_TOL})")
        # in turns: eager, artifact, artifact, eager
        rates = {"eager": [], "artifact": []}
        for kind in ("eager", "artifact", "artifact", "eager"):
            rates[kind].append(eager_serve(mode) if kind == "eager"
                               else artifact_serve(served)[0])
        eager_rate = statistics.median(rates["eager"])
        artifact_rate = statistics.median(rates["artifact"])
        print(f"[export] swin_unet_224 bf16, {op} "
              f"(fused image mode {mode}), symbolic batch: exported in "
              f"{stats['export_seconds']} s, {stats['bytes']} bytes; "
              f"{nodes} {op} nodes, no softmax; {launches} launches in one "
              f"forward at batch {BATCH}; max |artifact - predict| "
              f"{diff:.3g} (bar {SERVE_TOL}); in turns, artifact median "
              f"{artifact_rate:.1f} images/s of "
              f"{[round(r, 1) for r in sorted(rates['artifact'])]}, "
              f"predict_from_config {eager_rate:.1f} of "
              f"{[round(r, 1) for r in sorted(rates['eager'])]}; "
              f"{card_line()}", flush=True)
        results[op] = {"launches": launches, "nodes": nodes,
                       "seconds": stats["export_seconds"],
                       "bytes": stats["bytes"], "diff": diff,
                       "images_per_sec": artifact_rate,
                       "predict_images_per_sec": eager_rate}

    # the full-width U-Net in float32: the artifact against its module
    model, _, _, _ = build_trainer(unet_256_train_config(), "cuda")
    module = model.module.eval()
    exported = export.export_forward(module, (TRAIN_SIZE, TRAIN_SIZE, 3))
    path = tmp / "unet.pt2"
    export.save_exported(exported, str(path))
    served = export.load_exported(str(path))
    errs = []
    for b in (1, 3, 5):
        x = torch.rand(b, TRAIN_SIZE, TRAIN_SIZE, 3, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(b))
        with torch.no_grad():
            want = module(x)
        errs.append((served(x) - want).abs().max().item())
    check(max(errs) < EXPORT_F32_TOL,
          f"[export] unet_256 float32 artifact vs module: max |diff| "
          f"{errs} (bar {EXPORT_F32_TOL})")
    print(f"[export] unet_256 float32, symbolic batch, at b = 1, 3 and 5: max "
          f"|artifact - module| {max(errs):.3g} (bar {EXPORT_F32_TOL})",
          flush=True)
    del model, module, exported, served
    torch.cuda.empty_cache()
    return results


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


def unet_256_train_config(channels=None) -> dict:
    """``unet_256_train``: the JAX package's headline training step
    (``bench.py``, ``_unet_step_setup``): ``UNet(img_ch=3, output_ch=1,
    depth=4)`` with the default channels 64 -> 1024, SGD with momentum 0.9
    at lr 1e-3 (here under the COVID-QU U-Net config's poly decay), Dice
    loss; the metric that config logs, Dice at 0.5.  *channels* cuts the
    width and depth."""
    arch = {"in_channel_size": 3, "out_channel_size": 1, "depth": 4}
    if channels:
        arch.update(channels=tuple(channels), depth=len(channels) - 1)
    return {
        "model": {"segmentation.models.UNet": {"architecture": arch}},
        "training": {
            "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                "optim.scheduler.PolyLearningRateDecay": {
                    "base": 1e-3, "exponent": 0.9,
                    "iteration_unit": "batch",
                    "number_of_iterations": "auto"}}}},
            "loss": {"segmentation.losses.DiceLoss": {}}},
        "metrics": {"metrics": ("metrics.DiceIndex",)},
    }


def build_trainer(cfg: dict, device, seed: int = 0,
                  batches_per_epoch: int = 1000, device_augment=None):
    """The framework's own objects from a config: ``Model`` with its
    kaiming-normal ``weight_init``, the config's ``Loss``, ``Optimizer``
    with its schedule, ``MetricsCalculator``, ``TrainState`` and
    ``make_train_step`` (with *device_augment* in the step).  Returns
    (model, state, calculator, step)."""
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.losses import Loss
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.optim import Optimizer
    from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                        make_train_step)

    cd = ConfigDict(cfg)
    cd.expand()
    for key in ("model", "training/loss"):
        registry.fill_spec(cd, key)
    Model.fill_weight_init_kwargs(cd["model"].value())
    cd = cd.trim()  # as the CLI hands it on: {name: {}} back to name
    model_cfg = cd["model"].value()
    model = registry.build(cd, key="model", wrapper=Model)
    model.init(seed)
    model.init_weight(model_cfg, torch.Generator().manual_seed(seed + 1))
    model.module.to(device)
    optimizer = Optimizer(cd["training/optimizer"], num_epochs=1,
                          batches_per_epoch=batches_per_epoch)
    state = TrainState.create(model.module, optimizer.init(model.module),
                              seed)
    loss = registry.build(cd, key="training/loss", wrapper=Loss)
    calculator = MetricsCalculator(cd, loss=loss)
    return model, state, calculator, make_train_step(
        model, loss, calculator, optimizer, device_augment=device_augment)


def segmentation_batch(n_frag: int, frag_bs: int, size: int, seed: int):
    """A learnable synthetic batch stack: uint8 images with bright discs
    over noise, the discs as the mask; (n_frag, frag_bs, size, size, 3)
    and (n_frag, frag_bs, size, size)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    mask = np.zeros((n_frag * frag_bs, size, size), np.uint8)
    for m in mask:
        for _ in range(3):
            cy, cx = rng.integers(0, size, 2)
            r = rng.integers(size // 16, size // 5)
            m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    img = np.clip(60 + 120 * mask + rng.normal(0, 25, mask.shape), 0, 255)
    x = np.repeat(img.astype(np.uint8)[..., None], 3, axis=-1)
    return {"x": torch.from_numpy(x.reshape((n_frag, frag_bs) + x.shape[1:])),
            "mask": torch.from_numpy(mask.reshape((n_frag, frag_bs)
                                                  + mask.shape[1:]))}


def phase_train_small():
    """(a) A small float32 U-Net (depth 2, channels 8-16-32, BatchNorm),
    three steps of two fragments of 2 at 64 x 64, on the card and on the
    CPU from the same weights: loss, parameters and running statistics
    within TRAIN_TOL, TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = unet_256_train_config(channels=(8, 16, 32))
    runs = []
    for device in ("cpu", "cuda"):
        model, state, calculator, step = build_trainer(cfg, device)
        metrics_state = calculator.init_state(device)
        losses = []
        for k in range(3):
            batch = {key: v.to(device) for key, v in
                     segmentation_batch(2, 2, 64, seed=k).items()}
            state, metrics_state, per_batch = step(state, metrics_state,
                                                   batch)
            losses.append(per_batch["dice_loss"].item())
        runs.append((losses, {k: v.double().cpu() for k, v in
                              model.module.state_dict().items()}))
    (cpu_losses, cpu_state), (losses, state) = runs
    loss_err = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    state_err = {k: (v - cpu_state[k]).abs().max().item()
                 for k, v in state.items()}
    worst = max(state_err, key=state_err.get)
    stats_err = max(v for k, v in state_err.items() if "running" in k)
    check(loss_err < TRAIN_TOL and state_err[worst] < TRAIN_TOL,
          f"small f32 train step, card vs CPU: loss {loss_err}, "
          f"{worst} {state_err[worst]} (bar {TRAIN_TOL})")
    print(f"[train] small f32 U-Net, 3 steps of 2 fragments of 2 at 64x64, "
          f"card vs CPU: max |diff| loss {loss_err:.3g}, parameters and "
          f"running statistics {state_err[worst]:.3g} (running statistics "
          f"{stats_err:.3g}; bar {TRAIN_TOL})", flush=True)


def _trained_look(module, seed: int) -> None:
    """Draw every bias and BatchNorm scale from a seeded generator, in
    place: the initial ones (biases 0, scales 1) hide a dropped bias or a
    swapped scale for the first steps, as a trained checkpoint would
    not."""
    import torch

    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(".bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=generator))
            elif ".BatchNorm_" in name:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=generator))


def _bf16_stats_batch_norm(self, x):
    """A faulty BatchNorm forward: the batch statistics taken in bf16, the
    variance by the one-pass E[x^2] - E[x]^2."""
    import torch

    from medsegpretrainimagenet_tpu_torch.models.blocks import compute_dtype

    dtype = compute_dtype() or torch.float32
    x = x.to(dtype)
    mean = x.mean((0, 1, 2), dtype=torch.bfloat16)
    var = ((x * x).mean((0, 1, 2), dtype=torch.bfloat16)
           - mean * mean).float().clamp_min(0)
    mean = mean.float()
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        self.num_batches_tracked.add_(1)
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var * n / (n - 1), self.momentum)
    y = (x.float() - mean) * torch.rsqrt(var + self.eps) * self.weight \
        + self.bias
    return y.to(dtype)


def _bf16_readings(run_, ref):
    """Relative |run_ - ref| of two training runs from the same weights
    ({"loss", "norm": per step, "delta": each leaf's change over the
    steps}) per quantity of BF16_TRAIN_TOL, and the worst leaf of each
    leaf family (a model without BatchNorm has no running statistics)."""
    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    read = {"loss": ((run_["loss"] - ref["loss"]).abs()
                     / ref["loss"].abs()).max().item(),
            "gradient norm": ((run_["norm"] - ref["norm"]).abs()
                              / ref["norm"]).max().item()}
    worst = {}
    for family, stats_ in (("parameters", False),
                           ("running statistics", True)):
        leaves = {k: rel(d, ref["delta"][k])
                  for k, d in run_["delta"].items()
                  if ("running_" in k) == stats_
                  and ref["delta"][k].norm() > 0}
        if leaves:
            worst[family] = max(leaves, key=leaves.get)
            read[family] = leaves[worst[family]]
    return read, worst


def _run_record(model, logs, start) -> dict:
    """A training run's losses and gradient norms (*logs*, per step) and
    each leaf's change since *start* (float64, where *start* lies; conv
    biases left out, as [train bf16] leaves them out) for
    :func:`_bf16_readings`."""
    import torch

    end = model.state_dict()
    return {"loss": torch.stack([a for a, _ in logs]).double().cpu(),
            "norm": torch.stack([b for _, b in logs]).double().cpu(),
            "delta": {k: end[k].to(v.device, torch.float64) - v
                      for k, v in start.items()
                      if not re.search(r"\.Conv_\d+\.bias$", k)}}


def phase_train_bf16(seed: int = 0):
    """unet_256_train at full width in bf16 against the same port in
    float32 with TF32 off: BF16_STEPS steps from the same weights (biases
    and BatchNorm scales drawn, see _trained_look) on the same batch; the
    relative |bf16 - f32| of the losses, the gradient norms and the worst
    leaves' change within BF16_TRAIN_TOL.  The same comparison of three
    faulty bf16 runs (batch statistics taken in bf16, the conv bias
    dropped, the up-conv's SAME padding on the wrong side) must read
    BF16_FAULT_MARGIN times a bar or more, so the bars sit between sound
    and faulty."""
    import contextlib
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from medsegpretrainimagenet_tpu_torch.models import blocks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = {k: v.cuda() for k, v in segmentation_batch(
        1, TRAIN_BATCH, TRAIN_SIZE, seed=seed).items()}
    conv2d, axis_pads = F.conv2d, blocks._axis_pads

    def run(dtype, fault=contextlib.nullcontext()):
        blocks.set_compute_dtype(dtype)
        try:
            model, state, calculator, step = build_trainer(
                unet_256_train_config(), "cuda")
            _trained_look(model.module, seed=seed + 7)
            start = {k: v.double() for k, v in
                     model.module.state_dict().items() if v.is_floating_point()}
            metrics_state = calculator.init_state("cuda")
            logs = []
            with fault:
                for _ in range(BF16_STEPS):
                    state, metrics_state, per_batch = step(
                        state, metrics_state, batch)
                    logs.append((per_batch["dice_loss"],
                                 per_batch["gradient_magnitude"]))
            return _run_record(model.module, logs, start)
        finally:
            blocks.set_compute_dtype(None)

    readings = _bf16_readings
    t0 = time.perf_counter()
    ref = run(None)
    sound, worst = readings(run(torch.bfloat16), ref)
    print(f"[train bf16] unet_256_train, {BF16_STEPS} steps bf16 vs f32 "
          f"(TF32 off) from the same weights and batch (seed {seed}): "
          f"relative |diff| "
          + ", ".join(f"{k} {v:.3g} (bar {BF16_TRAIN_TOL[k]})"
                      for k, v in sound.items()) + f"; worst {worst}",
          flush=True)
    faults = {
        "batch statistics taken in bf16": mock.patch.object(
            blocks.BatchNorm, "forward", _bf16_stats_batch_norm),
        "conv bias dropped": mock.patch.object(
            F, "conv2d", lambda x, w, b=None, *a, **k: conv2d(x, w, None,
                                                               *a, **k)),
        "up-conv SAME padding on the wrong side": mock.patch.object(
            blocks, "_axis_pads", lambda padding, *a: tuple(
                (hi, lo) for lo, hi in axis_pads(padding, *a))
            if padding == "SAME" else axis_pads(padding, *a)),
    }
    caught = {}
    for name, fault in faults.items():
        read, worst = readings(run(torch.bfloat16, fault), ref)
        caught[name] = max(read[k] / BF16_TRAIN_TOL[k] for k in read)
        print(f"[train bf16] fault '{name}': "
              + ", ".join(f"{k} {v:.3g}" for k, v in read.items())
              + f"; worst {worst}; {caught[name]:.3g} x its bar",
              flush=True)
    torch.cuda.empty_cache()
    print(f"[train bf16] {time.perf_counter() - t0:.1f} s", flush=True)
    check(all(sound[k] < BF16_TRAIN_TOL[k] for k in sound),
          f"unet_256_train bf16 vs f32: {sound} (bars {BF16_TRAIN_TOL})")
    check(all(v >= BF16_FAULT_MARGIN for v in caught.values()),
          f"a fault reads under {BF16_FAULT_MARGIN} x the bf16 bars: "
          f"{caught}")


def conv_macs(module, x) -> tuple:
    """Multiply-adds of one forward of *module* on *x*, summed over the
    port's convolutions and dense layers from their output shapes, and over
    the two products of each window attention (q k^T and P v, N x N x C per
    window each): (all of them, those whose input is *x*, which need no
    input gradient)."""
    import torch

    from medsegpretrainimagenet_tpu_torch.models.blocks import Conv, Dense
    from medsegpretrainimagenet_tpu_torch.models.swin import WindowAttention

    counts = [0, 0]
    module.eval()  # no running-statistics update; the step sets train()

    def hook(layer, args, out):
        if isinstance(layer, WindowAttention):
            windows, n, c = args[0].shape
            macs = 2 * windows * n * n * c
        else:
            macs = out.numel() * layer.weight[0].numel()
        counts[0] += macs
        if args[0] is x:
            counts[1] += macs

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (Conv, Dense, WindowAttention))]
    try:
        with torch.no_grad():
            module(x)
    finally:
        for h in handles:
            h.remove()
    return tuple(counts)


#: kernel-name fragments -> the group they belong to in the train step's
#: breakdown; the first match wins
_TRAIN_GROUPS = (
    ("nchwtonhwc", "layout transforms"), ("nhwctonchw", "layout transforms"),
    ("transpose", "layout transforms"),
    ("batch_norm", "BatchNorm"), ("batchnorm", "BatchNorm"),
    ("bn_fw", "BatchNorm"), ("bn_bw", "BatchNorm"),
    ("max_pool", "pooling/upsample"), ("upsample", "pooling/upsample"),
    ("multi_tensor_apply", "optimizer, grad mean and norm (foreach)"),
    ("reduce_kernel", "reductions: conv bias grads, loss, metrics"),
    ("catarraybatchedcopy", "concat"),
    ("xmma", "convs (cuDNN)"), ("conv", "convs (cuDNN)"),
    ("wgrad", "convs (cuDNN)"), ("dgrad", "convs (cuDNN)"),
    ("gemm", "convs (cuDNN)"), ("cutlass", "convs (cuDNN)"),
    ("cudnn", "convs (cuDNN)"), ("winograd", "convs (cuDNN)"),
    ("elementwise", "elementwise: conv bias adds, ReLU, casts, copies"),
    ("copy", "elementwise: conv bias adds, ReLU, casts, copies"),
    ("fill", "elementwise: conv bias adds, ReLU, casts, copies"))


def profile_train(run_steps, steps: int, wall_ms: float,
                  tag: str = "train", groups_of=None,
                  unit: str = "step") -> None:
    """Device time per train step by kernel group (*groups_of*, by default
    ``_TRAIN_GROUPS``) and by operator, from torch.profiler over *steps*
    steps.  The busy share is the device time over the wall time of the
    same profiled steps; *wall_ms*, the median wall time of a step in the
    unprofiled turns, is printed beside it.  Lines start with ``[profile
    <tag>]``; *unit* names what one of the steps is.  Returns the device
    busy ms, the launches and each group's ms, per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(steps)
        torch.cuda.synchronize()
        profiled_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total]
    check(bool(kernels), f"[profile {tag}] the profiler recorded no "
                         f"kernels")
    busy = sum(e.device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"[profile {tag}] per {unit}: device busy {busy:.3f} ms of "
          f"{profiled_ms:.3f} ms wall in the profiled {unit}s "
          f"({100 * busy / profiled_ms:.1f} %; unprofiled {wall_ms:.3f} ms),"
          f" {launches:.0f} kernel launches")
    groups = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for frag, g in groups_of or _TRAIN_GROUPS
                      if frag in name), "other")
        groups[group] = groups.get(group, 0.0) \
            + e.device_time_total / 1e3 / steps
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile {tag}]   {group}: {ms:.3f} ms/{unit} "
              f"({100 * ms / busy:.1f} %)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:15]:
        print(f"[profile {tag}]   {e.device_time_total / 1e3 / steps:7.3f} "
              f"ms/{unit} {e.count / steps:5.1f}x {e.key[:160]}")
    # the same device time by the operator that launched it
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"[profile {tag} op]   "
              f"{e.self_device_time_total / 1e3 / steps:7.3f} ms/{unit} "
              f"{e.count / steps:5.1f}x {e.key}")
    sys.stdout.flush()
    return {"busy_ms": busy, "launches": launches, "groups": groups}


def _timed_turns(run_steps, label: str) -> list:
    """TURNS turns of TURN_STEPS steps, each under sync debug mode
    "error" (a host sync in a step raises); the seconds of each."""
    import torch

    turns = []
    for _ in range(TURNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_steps(TURN_STEPS)
        except RuntimeError as exc:
            fail(f"{label}: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        turns.append(time.perf_counter() - t0)
    return turns


def phase_train_full() -> float:
    """(b) and (c): unet_256_train at full width in bf16.  Returns the
    median images/s of the one-fragment turns."""
    import statistics as stats

    import torch

    from medsegpretrainimagenet_tpu_torch.models import blocks

    torch.backends.cudnn.benchmark = True
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = build_trainer(
            unet_256_train_config(), "cuda")
        n_params = sum(p.numel() for p in model.module.parameters())
        check(n_params == 31_080_449, f"unet_256_train has {n_params} "
                                      f"parameters")
        batch = {k: v.cuda() for k, v in segmentation_batch(
            1, TRAIN_BATCH, TRAIN_SIZE, seed=0).items()}
        x0 = (batch["x"][0, :1].float() / 255.0)
        macs, first_macs = conv_macs(model.module, x0)
        # forward, weight gradients, and input gradients of every conv but
        # those fed the image: 2 operations per multiply-add
        flops = 2 * TRAIN_BATCH * (3 * macs - first_macs)
        bound_ms = 1e3 * flops / PEAK_OPS_PER_S["torch.bfloat16"]
        print(f"[train] unet_256_train: {n_params} parameters, forward "
              f"{macs / 1e9:.2f} GMAC per image, train step "
              f"{flops / 1e12:.3f} TFLOP at batch {TRAIN_BATCH}: bound "
              f"{bound_ms:.3f} ms (operations, bf16 at 989 TFLOP/s)",
              flush=True)

        metrics_state = calculator.init_state("cuda")
        log = {"dice_loss": [], "gradient_magnitude": []}

        def run_steps(n, stack=batch):
            nonlocal state, metrics_state
            for _ in range(n):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       stack)
                for key in log:
                    log[key].append(per_batch[key])

        t0 = time.perf_counter()
        run_steps(3)  # cuDNN autotuning, allocator warm-up
        torch.cuda.synchronize()
        print(f"[train] warm-up, 3 steps: {time.perf_counter() - t0:.2f} s",
              flush=True)
        bn = model.module.enc.level_convs[0][0].BatchNorm_0
        stats_before = bn.running_mean.clone(), bn.running_var.clone()
        for values in log.values():
            values.clear()
        torch.cuda.reset_peak_memory_stats()
        turns = _timed_turns(run_steps, "[train] a host sync in a step")
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(log["dice_loss"]).cpu()
        norms = torch.stack(log["gradient_magnitude"]).cpu()
        moved = not (torch.equal(bn.running_mean, stats_before[0])
                     and torch.equal(bn.running_var, stats_before[1]))
        n = len(losses)
        check(bool(torch.isfinite(losses).all())
              and bool(losses[29] < losses[0]),
              f"unet_256_train losses: step 1 {losses[0].item()}, step 30 "
              f"{losses[29].item()}, all finite "
              f"{bool(torch.isfinite(losses).all())}")
        check(bool(torch.isfinite(norms).all()) and moved,
              f"unet_256_train: gradient norms finite "
              f"{bool(torch.isfinite(norms).all())}, running statistics "
              f"moved {moved}")
        step_ms = [1e3 * t / TURN_STEPS for t in turns]
        rates = [TRAIN_BATCH * TURN_STEPS / t for t in turns]
        wall_ms = stats.median(step_ms)
        print(f"[train] unet_256_train bf16, batch {TRAIN_BATCH}, "
              f"{TRAIN_SIZE}x{TRAIN_SIZE}, {n} steps on one batch with no "
              f"host sync queued (sync debug mode 'error'): dice loss step 1 "
              f"{losses[0].item():.4f}, step 30 {losses[29].item():.4f}, "
              f"step {n} {losses[-1].item():.4f}; gradient norm "
              f"{norms[0].item():.4g} -> {norms[-1].item():.4g}; running "
              f"statistics moved", flush=True)
        print(f"[train] images/s: median {stats.median(rates):.1f} of "
              f"{[round(r, 1) for r in sorted(rates)]} ({TURNS} turns of "
              f"{TURN_STEPS} steps); {wall_ms:.3f} ms per step, "
              f"{100 * bound_ms / wall_ms:.1f} % of the {bound_ms:.3f} ms "
              f"bound; peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
        profile_train(run_steps, 5, wall_ms)

        # two fragments of 8: accumulation at full width, in turns
        split = {k: v.reshape((2, TRAIN_BATCH // 2) + v.shape[2:])
                 for k, v in batch.items()}
        run_steps(2, split)  # autotuning of the batch-8 shapes
        split_rates = [TRAIN_BATCH * TURN_STEPS / t for t in _timed_turns(
            lambda n: run_steps(n, split),
            "[train] a host sync in a two-fragment step")]
        tail = torch.stack(log["dice_loss"][-TURNS * TURN_STEPS:]).cpu()
        check(bool(torch.isfinite(tail).all()),
              f"two-fragment losses {tail.tolist()}")
        split_rate = stats.median(split_rates)
        print(f"[train] two fragments of {TRAIN_BATCH // 2}, {TURNS} turns "
              f"of {TURN_STEPS} steps, no host sync: median "
              f"{split_rate:.1f} images/s of "
              f"{[round(r, 1) for r in sorted(split_rates)]}; dice loss "
              f"{tail[0].item():.4f} -> {tail[-1].item():.4f}", flush=True)
        profile_train(lambda n: run_steps(n, split), 5,
                      1e3 * TRAIN_BATCH / split_rate, tag="train 2x8")
        values = calculator.finalize_epoch(metrics_state)
        check(all(math.isfinite(v) for v in values.values()),
              f"epoch metrics {values}")
        print(f"[train] epoch row over all {state.step} steps: {values}",
              flush=True)
        return stats.median(rates)
    finally:
        blocks.set_compute_dtype(None)


#: [metrics]: one full-width batch (16 at 256 x 256) of predictions drawn
#: from a seed, binary (sigmoid) and 4-class (softmax)
METRIC_BATCH, METRIC_SIZE, METRIC_CLASSES = 16, 256, 4
#: the bar on the max |card - CPU| / max(1, |CPU|) of every metric's
#: per-step values and epoch row.  On an H100 the worst read 2.0e-7 (HD95,
#: 7.6e-6 on 37.7 pixels: the card and the CPU sum and interpolate in
#: another order); AUROC and AP read 1e-9 or less (float64 sums), the rest
#: 0
METRIC_TOL = 2e-6
MC = "metrics.multiclass_metrics."
#: (what, the metric names that build it, binary or multiclass inputs)
METRIC_CASES = (
    ("HD95Spec", ("metrics.ModifiedHausdorffDistance",), "binary"),
    ("AUCSpec area_under_roc", ("metrics.AUROC",), "binary"),
    ("AUCSpec average_precision_score", ("metrics.AveragePrecision",),
     "binary"),
    ("MultiClassCMSpec + AverageBinaryCMSpec + ClasswiseBinaryCMSpec + "
     "MCAccuracySpec", (MC + "DiceIndex", MC + "JaccardIndex",
                        MC + "ClasswiseAccuracies", MC + "Accuracy"),
     "multiclass"),
    ("AverageContinuousSpec area_under_roc", (MC + "AUROC",), "multiclass"),
    ("AverageContinuousSpec average_precision_score",
     (MC + "AveragePrecision",), "multiclass"),
    ("MCHD95Spec", (MC + "ModifiedHausdorffDistance",), "multiclass"))
#: the COVID-QU reference metric set (SURVEY.md:453) on the train step
COVIDQU_METRICS = ("metrics.DiceIndex", "metrics.JaccardIndex", "metrics.MCC",
                   "metrics.ModifiedHausdorffDistance", "metrics.AUROC")


def acdc_labels(rng, n: int, height: int, width: int):
    """(n, height, width) uint8 cardiac-like label maps: an LV disc (3)
    inside a myocardium ring (2), an RV crescent (1) beside it."""
    import numpy as np

    yy, xx = np.mgrid[:height, :width]
    out = np.zeros((n, height, width), np.uint8)
    for lab in out:
        cy = rng.integers(height // 3, 2 * height // 3)
        cx = rng.integers(width // 3, 2 * width // 3)
        r = rng.uniform(height / 16, height / 8)
        ring = rng.uniform(height / 40, height / 24)
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        lab[d2 < (r + ring) ** 2] = 2
        lab[d2 < r * r] = 3
        rv = (yy - cy) ** 2 + (xx - cx + r + ring) ** 2 < (r + ring) ** 2
        lab[rv & (lab == 0)] = 1
    return out


def metric_inputs(seed: int = 0) -> dict:
    """{'binary': (prediction, mask), 'multiclass': (...)} as numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mask = segmentation_batch(1, METRIC_BATCH, METRIC_SIZE,
                              seed=seed)["mask"][0].numpy()
    logits = rng.normal(0, 1.5, mask.shape) + 3.0 * (2.0 * mask - 1.0)
    binary = ((1 / (1 + np.exp(-logits)))[..., None].astype(np.float32),
              mask.astype(np.float32))
    labels = acdc_labels(rng, METRIC_BATCH, METRIC_SIZE, METRIC_SIZE)
    raw = rng.normal(0, 1.5, labels.shape + (METRIC_CLASSES,)) \
        + 3.0 * np.eye(METRIC_CLASSES)[labels]
    probs = np.exp(raw) / np.exp(raw).sum(-1, keepdims=True)
    return {"binary": binary,
            "multiclass": (probs.astype(np.float32),
                           labels.astype(np.int64))}


def _metric_run(names, inputs, device):
    """One update of a fresh calculator on *device*; (per-step values and
    epoch row on the host, calculator, state, prediction, batch)."""
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.metrics.calculator import to_host

    calc = MetricsCalculator(ConfigDict({"metrics": {
        "metrics": names,
        "calculation": {"number_of_classes": METRIC_CLASSES}}}))
    pred = torch.from_numpy(inputs[0]).to(device)
    batch = {"mask": torch.from_numpy(inputs[1]).to(device)}
    state, per_batch = calc.update(calc.init_state(device), pred, batch)
    return (to_host(per_batch), calc.finalize_epoch(state)), calc, pred, \
        batch


def _max_diff(a, b) -> float:
    import numpy as np

    (step_a, row_a), (step_b, row_b) = a, b
    if step_a.keys() != step_b.keys() or row_a.keys() != row_b.keys():
        fail(f"[metrics] the card and the CPU give different keys: "
             f"{sorted(step_a)} {sorted(row_a)} / {sorted(step_b)} "
             f"{sorted(row_b)}")
    pairs = [(np.asarray(step_a[k], np.float64),
              np.asarray(step_b[k], np.float64)) for k in step_a] \
        + [(np.float64(row_a[k]), np.float64(row_b[k])) for k in row_a]
    diffs = [float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))
             for a, b in pairs]
    return max(diffs) if diffs else 0.0


def phase_metrics(step_rate: float) -> None:
    """[metrics]: each metric of the suite on one full-width batch on the
    card against the same port on the CPU (max |card - CPU| under
    METRIC_TOL), under sync debug mode "error" (an update may not wait for
    the card) and under deterministic algorithms (the same values); its
    device ms per update (CUDA events, median of 5) and launches per
    update.  Then unet_256_train stepped with the COVID-QU reference
    metric set folded into the step, beside [train]'s Dice-only rate."""
    import statistics as stats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from medsegpretrainimagenet_tpu_torch.models import blocks

    inputs = metric_inputs()
    for what, names, kind in METRIC_CASES:
        cpu, _, _, _ = _metric_run(names, inputs[kind], "cpu")
        card, calc, pred, batch = _metric_run(names, inputs[kind], "cuda")
        err = _max_diff(card, cpu)
        check(err <= METRIC_TOL, f"[metrics] {what}: max |card - CPU| / "
                                 f"max(1, |CPU|) {err:.3g} (bar "
                                 f"{METRIC_TOL})")
        state0 = calc.init_state("cuda")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            calc.update(state0, pred, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.use_deterministic_algorithms(True)
        try:
            deterministic, _, _, _ = _metric_run(names, inputs[kind], "cuda")
        finally:
            torch.use_deterministic_algorithms(False)
        det_err = _max_diff(deterministic, card)
        check(det_err <= METRIC_TOL, f"[metrics] {what}: deterministic "
                                     f"against default {det_err:.3g}")
        times = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            calc.update(state0, pred, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calc.update(state0, pred, batch)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        print(f"[metrics] {what} ({kind}, {METRIC_BATCH}x{METRIC_SIZE}x"
              f"{METRIC_SIZE}): max |card - CPU| / max(1, |CPU|) {err:.3g}"
              f" (bar {METRIC_TOL}), deterministic against default "
              f"{det_err:.3g}; "
              f"{stats.median(times):.3f} ms per update (median of 5: "
              f"{[round(t, 3) for t in sorted(times)]}), {launches} "
              f"launches; no host sync (sync debug mode 'error')",
              flush=True)
        del calc, pred, batch, state0
        torch.cuda.empty_cache()

    # unet_256_train with the COVID-QU reference metric set in the step
    cfg = unet_256_train_config()
    cfg["metrics"] = {"metrics": COVIDQU_METRICS}
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = build_trainer(cfg, "cuda")
        batch = {k: v.cuda() for k, v in segmentation_batch(
            1, TRAIN_BATCH, TRAIN_SIZE, seed=0).items()}
        metrics_state = calculator.init_state("cuda")
        for _ in range(3):
            state, metrics_state, per_batch = step(state, metrics_state,
                                                   batch)
        rates = []
        for _ in range(TURNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(TURN_STEPS):
                    state, metrics_state, per_batch = step(
                        state, metrics_state, batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            rates.append(TRAIN_BATCH * TURN_STEPS
                         / (time.perf_counter() - t0))
        values = calculator.finalize_epoch(metrics_state)
        check(all(math.isfinite(v) for v in values.values())
              and values["metrics/modified_hausdorff_distance_threshold_0.5"]
              > 0, f"[metrics] epoch row with the COVID-QU set {values}")
        rate = stats.median(rates)
        print(f"[metrics] unet_256_train bf16 with the COVID-QU metric set "
              f"{list(COVIDQU_METRICS)} in the step, no host sync: median "
              f"{rate:.1f} images/s of {[round(r, 1) for r in sorted(rates)]}"
              f" ({1e3 * TRAIN_BATCH / rate:.2f} ms per step) against "
              f"[train]'s Dice-only {step_rate:.1f} images/s "
              f"({1e3 * TRAIN_BATCH / step_rate:.2f} ms) in this call; "
              f"epoch row {values}", flush=True)
        profile_train(lambda n: [step(state, metrics_state, batch)
                                 for _ in range(n)], 3,
                      1e3 * TRAIN_BATCH / rate, tag="metrics step")
    finally:
        blocks.set_compute_dtype(None)
    del model, state, calculator, step, metrics_state
    torch.cuda.empty_cache()


#: the [cli] run: COVID-QU-shaped synthetic data, 512 training images (32
#: steps of 16 per epoch) and 16 test images (the val split under
#: validate_on_test), 2 epochs, then a 3rd under --continued (cut from 3
#: and a 4th, to keep the script under 900 s beside [cli idrid]; from
#: 1024 images to 512 beside [remat] and [ln half], which halves the
#: profiler trace of the first epoch, most of its time)
CLI_IMAGES, CLI_TEST, CLI_EPOCHS, CLI_SIZE, CLI_BATCH = 512, 16, 2, 256, 16
#: epoch_logs.csv's columns for Dice loss and metrics.DiceIndex, the JAX
#: CLI's set (tests/test_torch_cli.py holds the two CLIs' sets equal)
CLI_EPOCH_COLUMNS = {"epoch", "learning_rate", "dice_loss",
                     "metrics/dice_index_threshold_0.5", "val_dice_loss",
                     "val_metrics/dice_index_threshold_0.5"}
#: what a failed batch, epoch, run or experiment prints through the error
#: envelope
ENVELOPE_MARKS = ("Exception occured", "Traceback")


def cli_config(workdir: Path, epochs: int, absolute_path=None,
               measured: bool = True) -> dict:
    """The port's counterpart of the JAX package's CLI-epoch config
    (``bench.py:1072-1109``): UNet depth 4 with the default channels 64 ->
    1024, 256 x 256, batch 16, bf16, async checkpoints, profiling, Dice loss
    and metrics.DiceIndex, SGD momentum 0.9 at a constant lr of 0.01,
    validate_on_test.  Added: RepeatChannels for train and val, the mask
    cast, and the watched metric, so that a best model is written.
    A run that is not *measured* (the --continued runs and [cli
    transfer]) writes no timing files and no profiler trace and skips
    cuDNN's autotuning, a large part of a process's first epoch."""
    technical = {"seed": 777, "save_destination": str(workdir / "logs"),
                 "maximum_actual_batch_size": CLI_BATCH,
                 "mixed_precision": True, "async_checkpointing": True,
                 "profile": measured, "use_cudnn_benchmarking": measured,
                 "export_plots_as": ("json",),
                 "model_evaluation": {
                     "metric": "val_metrics/dice_index_threshold_0.5",
                     "mode": "max"}}
    if absolute_path is not None:
        technical["absolute_path"] = absolute_path
    return {
        "experiment": {"number_of_epochs": epochs, "number_of_trials": 1},
        "meta": {"technical": technical},
        "data": {"data": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": CLI_SIZE,
            "validate_on_test": True, "seed": 20231027}},
            "sampling": {"batch_size": CLI_BATCH},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": {"segmentation.models.UNet": {
            "architecture": {"in_channel_size": 3, "out_channel_size": 1,
                             "depth": 4},
            "final_activation": "sigmoid"}},
        "training": {"loss": {"segmentation.losses.DiceLoss": {}},
                     "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                         "constant": {"base": 0.01}}}}},
        "metrics": {"metrics": ("metrics.DiceIndex",)},
    }


def write_covidqu_tree(root: Path, seed: int = 0, images: int = CLI_IMAGES,
                       size: int = CLI_SIZE, test: int = CLI_TEST) -> None:
    """A COVID-QU tree as ``bench.py:1061-1071`` writes it, *images* and
    *test* images of *size* x *size*, with bright discs over noise as the
    images and the discs as the infection mask (values 0/2), so that the
    Dice has something to learn."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    base = root / "COVID_QU" / "Inf_segm" / "data arrays" / "COVID-19"
    for part, n in (("train and val", images), ("test", test)):
        masks = np.zeros((n, 1, size, size), np.uint8)
        for m in masks[:, 0]:
            for _ in range(3):
                cy, cx = rng.integers(0, size, 2)
                r = rng.integers(size // 16, size // 5)
                m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 2
        noise = rng.normal(0, 25, masks.shape).astype(np.float32)
        imgs = np.clip(60 + 60 * masks + noise, 0, 255).astype(np.uint8)
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy", imgs)
        np.save(d / "inf_masks.npy", masks)


def _csv_rows(path: Path) -> list:
    import csv

    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _cli_process(workdir: Path, config: dict, *modifiers: str,
                 launcher=None):
    """``python3 -m medsegpretrainimagenet_tpu_torch.cli`` as a user runs
    it, in a process of its own (or the Python source *launcher* with the
    same arguments).  Returns (wall seconds, the finished process)."""
    import os

    from medsegpretrainimagenet_tpu_torch.config import dump_yaml

    path = workdir / f"cli_{config['experiment']['number_of_epochs']}.yaml"
    path.write_text(dump_yaml(config))
    env = dict(os.environ, MST_DATA_DIR=str(workdir / "data"),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    entry = ["-m", "medsegpretrainimagenet_tpu_torch.cli"] \
        if launcher is None else ["-c", launcher]
    out = subprocess.run(
        [sys.executable, *entry, str(path), *modifiers], cwd=workdir,
        env=env, capture_output=True, text=True, timeout=400)
    return time.perf_counter() - t0, out


def _run_cli(workdir: Path, config: dict, *modifiers: str) -> float:
    """:func:`_cli_process`, failing on a non-zero exit or on anything
    the error envelope printed.  Returns the wall seconds."""
    seconds, out = _cli_process(workdir, config, *modifiers)
    marks = [m for m in ENVELOPE_MARKS if m in out.stderr]
    check(out.returncode == 0 and not marks,
          f"[cli] {' '.join(out.args[3:])}: exit {out.returncode}, "
          f"envelope marks {marks}; stderr tail:\n{out.stderr[-4000:]}")
    return seconds


def _check_run(run: Path, epochs: int, module) -> list:
    """The run directory after *epochs* epochs; returns the epoch rows."""
    import torch

    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

    rows = _csv_rows(run / "epoch_logs.csv")
    check(len(rows) == epochs and set(rows[0]) == CLI_EPOCH_COLUMNS,
          f"[cli] epoch_logs.csv: {len(rows)} rows (want {epochs}), "
          f"columns {sorted(rows[0]) if rows else None}")
    steps = CLI_IMAGES // CLI_BATCH
    batch_rows = _csv_rows(run / "batch_logs.csv")
    check(len(batch_rows) == steps * epochs,
          f"[cli] batch_logs.csv: {len(batch_rows)} rows, want "
          f"{steps} per epoch for {epochs} epochs")
    # COVID-QU has no test split: validate_on_test folds it into val, and
    # neither CLI writes test_logs.csv for it (the in-process part below
    # runs the test pass)
    check(not (run / "test_logs.csv").exists(),
          "[cli] test_logs.csv written for a reader without a test split")
    for name in ("last_model_state_dict.pt", "best_model_state_dict.pt"):
        module.load_state_dict(ckpt.load_params_file(run / name))
    saved = ckpt.load_state_file(run / "optimizer_state_dict.pt")
    check(saved["step"] == saved["micro_step"] == steps * epochs
          and len(saved["optimizer"]["state"]) > 0,
          f"[cli] optimizer_state_dict.pt: step {saved['step']}")
    schedule = ckpt.load_state_file(run / "scheduler_state_dict.pt")
    check(schedule["step"] == steps * epochs, f"[cli] scheduler {schedule}")
    check(ckpt.load_params_file(run / "checkpoint_epoch.pt")
          == {"epoch": epochs}, "[cli] checkpoint_epoch.pt")
    for row in rows:
        check(all(math.isfinite(float(v)) for v in row.values()),
              f"[cli] epoch row {row}")
    torch.cuda.empty_cache()
    return rows


def _count_syncs(fn) -> int:
    """Host syncs that *fn* queues, as torch's sync debug mode reports
    them (one warning each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_cli_in_process(workdir: Path) -> None:
    """One epoch's parts of the CLI in this process, over the CLI's own
    loader and data: the host syncs of ``run_epoch`` at two step counts
    (they must not grow with the steps), the host assembly and the
    host-to-device copy per batch, the device's busy share over a profiled
    stretch, and the test pass."""
    import itertools

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.data import BalancedDataLoader
    from medsegpretrainimagenet_tpu_torch.data.loader import PinnedCopier
    from medsegpretrainimagenet_tpu_torch.data.readers.covidqu import \
        COVIDQUDataset
    from medsegpretrainimagenet_tpu_torch.data.transforms import (
        Compose, ConvertToType, RepeatChannels)
    from medsegpretrainimagenet_tpu_torch.models import blocks
    from medsegpretrainimagenet_tpu_torch.train import (make_eval_step,
                                                        run_epoch)

    import os
    os.environ["MST_DATA_DIR"] = str(workdir / "data")
    cfg = cli_config(workdir, 1)
    data_cfg = ConfigDict(cfg["data"]["data"][
        "segmentation.datasets.COVIDQUDataset"])
    dataset = COVIDQUDataset(data_cfg)
    sampling = ConfigDict({"sampling": {"batch size": CLI_BATCH}})
    BalancedDataLoader.fill_kwargs(sampling["sampling"])
    pipeline = Compose(RepeatChannels(),
                       ConvertToType({"mask": "torch.LongTensor"}))

    def loader(split):
        return BalancedDataLoader(getattr(dataset, split),
                                  sampling["sampling/train"], bs=CLI_BATCH,
                                  actual_bs=CLI_BATCH, transforms=pipeline,
                                  seed=1)

    # host assembly, staging into pinned memory, and the copy to the card,
    # per batch
    train = loader("train")
    t0 = time.perf_counter()
    host = list(itertools.islice(iter(train), 16))
    assembly_ms = 1e3 * (time.perf_counter() - t0) / len(host)
    stacks = [{k: v[None] for k, v in batch.items()} for batch in host]
    copier = PinnedCopier(torch.device("cuda"))
    for stack in stacks[:4]:  # the pinned allocator's first blocks
        copier(stack)
    check(all(t.is_pinned() for t in copier.last_host.values()),
          "[cli] the prefetch's host buffers are not pinned")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for stack in stacks:
        copier(stack)
    copy_ms = 1e3 * (time.perf_counter() - t0) / len(stacks)
    pinned = list(copier.last_host.values())
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(16):
        for t in pinned:
            t.to("cuda", non_blocking=True)
    end.record()
    end.synchronize()
    h2d_ms = start.elapsed_time(end) / 16
    nbytes = sum(t.nbytes for t in pinned)
    print(f"[cli] host assembly {assembly_ms:.2f} ms per batch of "
          f"{CLI_BATCH} (transforms, stacking); the prefetch's staging "
          f"into pinned memory and queued copy {copy_ms:.2f} ms of host "
          f"time; host-to-device copy {h2d_ms:.3f} ms of device time per "
          f"batch ({nbytes / 2 ** 20:.1f} MiB, {nbytes / h2d_ms / 1e6:.1f} "
          f"GB/s)", flush=True)

    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = build_trainer(
            unet_256_train_config(), "cuda")
        log = workdir / "in_process_batch_logs.csv"
        syncs = {}
        for steps in (2, 4, 16):
            batches = host[:steps]
            metrics_state = calculator.init_state("cuda")

            def one_epoch():
                nonlocal state, metrics_state
                state, metrics_state = run_epoch(
                    step, state, metrics_state, batches, device="cuda",
                    log_path=str(log), calculator=calculator)
                calculator.finalize_epoch(metrics_state)
            # the first run, at 2 steps, warms up the pinned allocator
            syncs[steps] = _count_syncs(one_epoch)
        check(syncs[4] == syncs[16] and syncs[4] <= 8,
              f"[cli] host syncs of run_epoch grow with the steps: {syncs}")
        print(f"[cli] run_epoch host syncs (sync debug mode 'warn'), batch "
              f"log read-back and epoch metrics included: {syncs[4]} at 4 "
              f"steps, {syncs[16]} at 16 steps", flush=True)

        batches = host
        metrics_state = calculator.init_state("cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics_state = run_epoch(
                step, state, metrics_state, batches, device="cuda",
                log_path=str(log), calculator=calculator)
            calculator.finalize_epoch(metrics_state)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        busy_ms = sum(e.device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
        print(f"[profile cli] run_epoch over {len(batches)} assembled "
              f"batches (copies to the card, steps, batch log): device "
              f"busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
              f"({100 * busy_ms / wall_ms:.1f} %)", flush=True)

        # the 16 test images: the val split under validate_on_test
        test = loader("val")
        metrics_state = calculator.init_state("cuda")
        _, metrics_state = run_epoch(make_eval_step(model, calculator.loss,
                                                    calculator),
                                     state, metrics_state, test,
                                     train=False, device="cuda")
        values = calculator.finalize_epoch(metrics_state)
        check(len(values) == 2 and all(math.isfinite(v)
                                       for v in values.values()),
              f"[cli] test pass {values}")
        print(f"[cli] test pass over {CLI_TEST} images: {values}",
              flush=True)
    finally:
        blocks.set_compute_dtype(None)


def phase_cli(step_rate: float) -> None:
    """The port's experiment CLI as a user runs it: CLI_EPOCHS epochs of
    the full-width CLI config in a process of its own, then one more epoch
    under --continued; the run files, row counts, learning and timings;
    then the in-process epoch."""
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model

    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        write_covidqu_tree(workdir / "data")
        print(f"[cli] synthetic COVID-QU tree: {CLI_IMAGES} + {CLI_TEST} "
              f"images of {CLI_SIZE}x{CLI_SIZE} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        seconds = _run_cli(workdir, cli_config(workdir, CLI_EPOCHS))
        (exp,) = (workdir / "logs").glob("*/Experiment")
        run = exp / "run_1"
        for name in ("config.yaml", "source_config.yaml", "environment.txt"):
            check((exp / name).is_file(), f"[cli] {name} missing")
        cd = ConfigDict({"model": cli_config(workdir, 1)["model"]})
        cd.expand()
        registry.fill_spec(cd, "model")
        module = registry.build(cd, key="model", wrapper=Model).module
        rows = _check_run(run, CLI_EPOCHS, module)
        losses = [float(r["dice_loss"]) for r in rows]
        dice = [float(r["val_metrics/dice_index_threshold_0.5"])
                for r in rows]
        check(losses[-1] < losses[0] and dice[-1] > dice[0],
              f"[cli] dice_loss {losses}, val Dice {dice}")
        print(f"[cli] {CLI_EPOCHS} epochs in {seconds:.1f} s of wall time "
              f"(process included): dice_loss {losses}, val Dice {dice}",
              flush=True)
        epoch_times = _csv_rows(run / "profile" / "epoch_times.csv")
        step_times = _csv_rows(run / "profile" / "step_times.csv")
        for row, steps in zip(epoch_times, step_times):
            train_s = float(row["train_s"])
            rate = CLI_IMAGES / train_s
            print(f"[cli] epoch {row['epoch']}: train {train_s:.3f} s = "
                  f"{rate:.1f} images/s ({100 * rate / step_rate:.1f} % of "
                  f"[train]'s {step_rate:.1f} step-only images/s), val "
                  f"{float(row['val_s']):.3f} s, checkpoints "
                  f"{float(row['ckpt_s']):.3f} s; device time per step "
                  f"mean {1e3 * float(steps['mean_s']):.2f} ms, p50 "
                  f"{1e3 * float(steps['p50_s']):.2f}, max "
                  f"{1e3 * float(steps['max_s']):.2f}", flush=True)

        # the resumed epoch runs under deterministic algorithms: an
        # operation without a deterministic CUDA kernel raises inside the
        # error envelope and is reported by name
        continued = cli_config(workdir, CLI_EPOCHS + 1,
                               absolute_path=str(exp) + "/", measured=False)
        continued["meta"]["technical"]["use_deterministic_algorithms"] = True
        seconds, out = _cli_process(workdir, continued, "--continued")
        raised = sorted(set(re.findall(
            r"(\S+) does not have a deterministic implementation",
            out.stderr)))
        marks = [m for m in ENVELOPE_MARKS if m in out.stderr]
        check(out.returncode == 0 and not raised and not marks,
              f"[cli det] --continued under deterministic algorithms: exit "
              f"{out.returncode}, operations without a deterministic CUDA "
              f"kernel {raised}, envelope marks {marks}; stderr tail:\n"
              f"{out.stderr[-4000:]}")
        print(f"[cli det] the [cli] config under deterministic algorithms "
              f"(the --continued epoch): operations without a deterministic "
              f"CUDA kernel that raised: none", flush=True)
        rows = _check_run(run, CLI_EPOCHS + 1, module)
        check([int(r["epoch"]) for r in rows]
              == list(range(1, CLI_EPOCHS + 2)), "[cli] resumed epochs")
        for name in ("last_model_state_dict_checkpoint.pt",
                     "optimizer_state_dict_checkpoint.pt"):
            check((run / name).is_file(), f"[cli] {name} missing")
        print(f"[cli] --continued: epoch {CLI_EPOCHS + 1} in {seconds:.1f} s"
              f" of wall time: dice_loss {rows[-1]['dice_loss']}, val Dice "
              f"{rows[-1]['val_metrics/dice_index_threshold_0.5']}",
              flush=True)
        del module
        torch.cuda.empty_cache()
        phase_cli_in_process(workdir)
    print(f"[cli] {time.perf_counter() - t0:.1f} s", flush=True)


#: [ddp]: images of the tree, and the bar on |torchrun - plain| of every
#: epoch_logs.csv column
DDP_IMAGES, DDP_TOL = 64, 1e-4
#: what torchrun runs: this script's ddp_worker in the launched process
_DDP_LAUNCHER = """import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.ddp_worker(sys.argv[2], sys.argv[3] == "step"))
"""


def ddp_worker(config_path: str, time_step: bool = True) -> int:
    """The process ``torchrun`` starts for [ddp]: join the NCCL group on
    cuda:LOCAL_RANK, run the experiment CLI on *config_path* (its
    data-parallel path: shard, global BatchNorm statistics, gathered
    outputs, summed gradients; or the layout its tensor_parallel or
    spatial_sharding asks for), then, with *time_step*, time
    unet_256_train's step on a sharded batch as [train] times it and print
    its images/s."""
    import torch
    import torch.distributed as dist

    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.cli.experiment import \
        main as cli_main
    from medsegpretrainimagenet_tpu_torch.models import blocks

    device = parallel.initialize_distributed()
    try:
        check(dist.get_backend() == "nccl" and device.type == "cuda",
              f"[ddp] backend {dist.get_backend()} on {device}")
        cli_main([config_path])
        if not time_step:
            return 0
        parallel.create_grid()
        torch.backends.cudnn.benchmark = True
        blocks.set_compute_dtype(torch.bfloat16)
        try:
            _, state, calculator, step = build_trainer(
                unet_256_train_config(), device)
            batch = parallel.shard_batch({k: v.to(device) for k, v in
                                          segmentation_batch(
                                              1, TRAIN_BATCH, TRAIN_SIZE,
                                              seed=0).items()})
            check(batch.get(parallel.SHARDED_KEY, False),
                  "[ddp] the batch was not marked as a shard")
            metrics_state = calculator.init_state(device)
            losses = []

            def run_steps(n):
                nonlocal state, metrics_state
                for _ in range(n):
                    state, metrics_state, per_batch = step(
                        state, metrics_state, batch)
                    losses.append(per_batch["dice_loss"])

            run_steps(3)  # cuDNN autotuning, NCCL set-up
            rates = [TRAIN_BATCH * TURN_STEPS / t for t in _timed_turns(
                run_steps, "[ddp] a host sync in a data-parallel step")]
            if parallel.is_main_process():
                profile_train(run_steps, 1,
                              1e3 * TRAIN_BATCH / statistics.median(rates),
                              tag="ddp step", groups_of=_PARALLEL_GROUPS)
            else:
                run_steps(1)  # the profiled step's collectives
            tail = torch.stack(losses).cpu()
            check(bool(torch.isfinite(tail).all()) and tail[-1] < tail[0],
                  f"[ddp] step losses {tail[0].item()} -> "
                  f"{tail[-1].item()}")
        finally:
            blocks.set_compute_dtype(None)
        if parallel.is_main_process():
            print(f"[ddp rate] {statistics.median(rates):.1f} "
                  f"{[round(r, 1) for r in sorted(rates)]}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def phase_ddp(step_rate: float, variants=None) -> None:
    """[ddp]: ``torchrun --standalone --nproc_per_node 1`` of a one-epoch
    COVID-QU CLI run (the [cli] config in float32, DDP_IMAGES images,
    deterministic algorithms) under NCCL, against the same run of the
    plain CLI: every epoch_logs.csv value within DDP_TOL, the same files.
    Then the data-parallel step's images/s under the group beside
    [train]'s.  *variants* (``--only parallel``, four cards) runs other
    launches against the same plain run: (tag, processes, the
    meta/technical it adds, whether the step is timed after it).  Two or
    more ranks' equality to one process is held on the CPU too
    (tests/test_torch_parallel.py and the tensor, spatial and pipeline
    tests).  Both processes run with TF32 off (``NVIDIA_TF32_OVERRIDE=0``):
    TF32 rounds each conv's inputs to 10 bits, which turns the global-batch
    BatchNorm's float32 sums, ordered otherwise than cuDNN's, into
    differences above the bar."""
    import os

    (ROOT / "build").mkdir(exist_ok=True)
    saved_tf32 = os.environ.get("NVIDIA_TF32_OVERRIDE")
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"  # the subprocesses only
    try:
        _ddp_runs(step_rate, variants or [("ddp", 1, {}, True)])
    finally:
        if saved_tf32 is None:
            os.environ.pop("NVIDIA_TF32_OVERRIDE")
        else:
            os.environ["NVIDIA_TF32_OVERRIDE"] = saved_tf32


def _ddp_runs(step_rate: float, variants) -> None:
    """The runs of :func:`phase_ddp` and their checks."""
    import os

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        runs = {}
        for tag, nproc, technical, time_step in [("plain", 0, {}, False),
                                                  *variants]:
            workdir = Path(tmp) / tag
            workdir.mkdir()
            if tag == "plain":
                write_covidqu_tree(workdir / "data", images=DDP_IMAGES)
            else:
                (workdir / "data").symlink_to(Path(tmp) / "plain" / "data")
            cfg = cli_config(workdir, 1, measured=False)
            cfg["meta"]["technical"].update(
                mixed_precision=False, use_deterministic_algorithms=True,
                async_checkpointing=False, **technical)
            if tag == "plain":
                # one card: the CLI refuses several visible to one process
                saved = os.environ.get("CUDA_VISIBLE_DEVICES")
                os.environ["CUDA_VISIBLE_DEVICES"] = "0"
                try:
                    seconds, out = _cli_process(workdir, cfg)
                finally:
                    if saved is None:
                        os.environ.pop("CUDA_VISIBLE_DEVICES")
                    else:
                        os.environ["CUDA_VISIBLE_DEVICES"] = saved
            else:
                seconds, out = _torchrun_cli(workdir, cfg, nproc, time_step)
            marks = [m for m in ENVELOPE_MARKS if m in out.stderr]
            check(out.returncode == 0 and not marks,
                  f"[{tag}] run: exit {out.returncode}, envelope marks "
                  f"{marks}; stderr tail:\n{out.stderr[-4000:]}")
            (run,) = (workdir / "logs").glob("*/Experiment/run_1")
            runs[tag] = (run, _csv_rows(run / "epoch_logs.csv"), seconds,
                         out.stdout)
        plain_run, want, plain_s, _ = runs["plain"]
        failures = []  # every launch is read before one fails the phase
        for tag, nproc, technical, time_step in variants:
            ddp_run, got, ddp_s, stdout = runs[tag]
            files = [sorted(p.name for p in run.iterdir())
                     for run in (plain_run, ddp_run)]
            if not (files[0] == files[1] and len(got) == len(want) == 1
                    and list(got[0]) == list(want[0])):
                failures.append(f"[{tag}] run files {files}, rows {got} vs "
                                f"{want}")
                continue
            diffs = {k: abs(float(got[0][k]) - float(want[0][k]))
                     for k in want[0]}
            worst = max(diffs, key=diffs.get)
            if diffs[worst] >= DDP_TOL:
                failures.append(
                    f"[{tag}] epoch_logs.csv under torchrun vs plain: "
                    f"{worst} differs by {diffs[worst]} (bar {DDP_TOL}); "
                    f"every column: {diffs}")
            layout = ", ".join(f"{k} {v}" for k, v in technical.items()) \
                or "data parallelism"
            print(f"[{tag}] torchrun --nproc_per_node {nproc} (NCCL, "
                  f"{layout}), one epoch of {DDP_IMAGES} images through "
                  f"the CLI in float32 (TF32 off) under deterministic "
                  f"algorithms: {ddp_s:.1f} s of wall time"
                  f"{' (with the step timing below)' if time_step else ''} "
                  f"against {plain_s:.1f} s for the plain CLI; "
                  f"epoch_logs.csv against it (bar {DDP_TOL}): worst "
                  f"{worst} {diffs[worst]:.3g}; the same run files",
                  flush=True)
            if not time_step:
                continue
            rate_line = [line for line in stdout.splitlines()
                         if line.startswith("[ddp rate]")]
            if len(rate_line) != 1:
                failures.append(f"[{tag}] no rate line in {stdout[-2000:]}")
                continue
            median, turns = rate_line[0].split(" ", 3)[2:]
            beside = f", [train]'s {step_rate:.1f} on one card" \
                if step_rate else ""
            print(f"[{tag}] unet_256_train bf16 step on a sharded batch "
                  f"under the process group of {nproc}: median {median} "
                  f"images/s of {turns} ({TURNS} turns of {TURN_STEPS} "
                  f"steps, no host sync){beside}; {card_line()}",
                  flush=True)
            print("\n".join(line for line in stdout.splitlines()
                            if line.startswith("[profile ddp step")),
                  flush=True)
        check(not failures, "; ".join(failures))


def _torchrun_cli(workdir: Path, config: dict, nproc: int = 1,
                  time_step: bool = True):
    """``torchrun --standalone --nproc_per_node NPROC`` of
    :func:`ddp_worker` on *config* in *workdir*.  Returns (wall seconds,
    the finished process)."""
    import os

    from medsegpretrainimagenet_tpu_torch.config import dump_yaml

    path = workdir / "cli_ddp.yaml"
    path.write_text(dump_yaml(config))
    (workdir / "launch.py").write_text(_DDP_LAUNCHER)
    env = dict(os.environ, MST_DATA_DIR=str(workdir / "data"),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), str(workdir / "launch.py"),
         str(ROOT), str(path), "step" if time_step else "cli"], cwd=workdir,
        env=env, capture_output=True, text=True, timeout=400)
    return time.perf_counter() - t0, out


#: [tp], [sp], [pp]: steps from the same weights and batch, and the bar on
#: the relative |parallel - one process| of the losses, the first step's
#: gradient norm and the worst parameter leaf (max |diff| over the leaf's
#: max |value|), all float32 with TF32 off, as [train] holds the card
#: against the CPU.  (unet_256_train's float32 gradient is itself 1e-3
#: from a float64 run's in its first-level convs, its norm 8e-5: the
#: later steps' norms part by more than the bar and are printed only); the
#: Swin step's batch (swin_224_train's is 24) and its stochastic depth (off:
#: on a data axis of 2 the two halves draw their own masks); the pipeline's
#: microbatches, batch and DoubleSwin stage (swin_224's level 0)
PARALLEL_STEPS, PARALLEL_TOL = 3, 1e-4
TP_MIN_CHANNELS, TP_SWIN_BATCH = 256, 8
#: [sp]'s unet_encoder_224_pretrain batch
SP_PRETRAIN_BATCH = 16
PP_MICROBATCHES, PP_BATCH = 4, 8
PP_STAGE = dict(in_channels=96, embed_dim=96, img_size=224, patch_size=4,
                depth=2, num_heads_layers=(3, 6, 12, 24), window_size=7)
#: what torchrun runs for them: this script's parallel_worker
_PARALLEL_LAUNCHER = """import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.parallel_worker(sys.argv[2]))
"""
#: the profiles' kernel groups, with the collectives apart
_PARALLEL_GROUPS = (("nccl", "collectives (NCCL)"),) + _TRAIN_GROUPS


def _relative(got: dict, want: dict, count: int = 1):
    """(worst leaf, max |got - want| over max |want| of it) over the
    floating leaves of two state dicts; with *count* > 1 the *count* worst
    such pairs."""
    read = {k: ((got[k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            .item() for k, v in want.items() if v.is_floating_point()}
    order = sorted(read, key=read.get, reverse=True)
    if count > 1:
        return [(k, read[k]) for k in order[:count]]
    return order[0], read[order[0]]


def _grid_steps(cfg: dict, batch: dict, device, layout=None, inner=None,
                tp_min_channels=None, profile_tag=None,
                fused_image: str = "off") -> dict:
    """PARALLEL_STEPS steps of *cfg* (built as build_trainer builds it,
    the biases and norm scales drawn by _trained_look) on *batch*: in one
    process when *layout* is None, else on the grid ``("data", inner)`` of
    *layout*, each process on its shard (its output channels under
    ``tensor_parallel``, its rows under ``spatial``), the Swin blocks in
    *fused_image* mode.  Returns the losses, gradient norms, the whole
    parameters on the host, ms per step (each step synchronised), K1's and
    K2's launches per step, forward and backward, and the sharded
    share."""
    import torch

    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.ops import set_fused_image_mode
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.parallel import tp

    if layout is not None:
        parallel.create_grid(("data", inner) if inner else ("data",), layout)
    model, state, calculator, step = build_trainer(cfg, device)
    _trained_look(model.module, seed=7)
    model.module.to(device)
    share = 0.0
    if layout is not None:
        parallel.put_replicated(model.module)
        if tp_min_channels:
            parallel.shard_train_state(model.module, state.optimizer,
                                       min_channels=tp_min_channels)
            share = tp.sharded_share(model.module)
        batch = parallel.shard_batch(
            batch, spatial_axis="spatial" if inner == "spatial" else None)
        check(batch.get(parallel.SHARDED_KEY, False),
              f"[parallel] {layout}: the batch was not marked as a shard")
    metrics_state = calculator.init_state(device)
    losses, norms, ms = [], [], []
    kernels = (wa.window_attention_cuda, wa.image_attention_cuda,
               wa.window_attention_backward_cuda,
               wa.image_attention_backward_cuda)
    for kernel in kernels:
        kernel.launches = 0

    def run(n):
        nonlocal state, metrics_state
        for _ in range(n):
            state, metrics_state, per_batch = step(state, metrics_state,
                                                   batch)
            losses.append(per_batch[calculator.loss.name])
            norms.append(per_batch["gradient_magnitude"])

    set_fused_image_mode(fused_image)
    try:
        for _ in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(1)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        launches, k2_launches, bwd_launches, k2_bwd_launches = (
            kernel.launches / PARALLEL_STEPS for kernel in kernels)
        # copied to the host before any further step: a state dict's
        # tensors are the live parameters
        names = {name for name, _ in model.module.named_parameters()}
        params = {k: v.double().cpu() for k, v in
                  parallel.full_state_dict(model.module).items()
                  if k in names}
        if profile_tag is not None and parallel.rank() == 0:
            profile_train(run, 1, statistics.median(ms), tag=profile_tag,
                          groups_of=_PARALLEL_GROUPS)
        elif profile_tag is not None:
            run(1)  # the other ranks take the profiled step's collectives
    finally:
        set_fused_image_mode("off")
    out = {"loss": torch.stack(losses[:PARALLEL_STEPS]).double().cpu(),
           "norm": torch.stack(norms[:PARALLEL_STEPS]).double().cpu(),
           "params": params,
           "ms": ms, "launches": launches, "k2_launches": k2_launches,
           "bwd_launches": bwd_launches, "k2_bwd_launches": k2_bwd_launches,
           "share": share}
    del model, state, step
    torch.cuda.empty_cache()
    return out


def _held(tag: str, got: dict, want: dict, extra: str = "") -> dict:
    """Print and check one grid run against the one-process run: the
    losses of every step, the gradient norm of the first (the later steps'
    start from parameters that part by float32 rounding, and this norm
    reads 8e-5 from a float64 run's in one process), the worst parameter
    leaf after the steps."""
    loss = ((got["loss"] - want["loss"]).abs()
            / want["loss"].abs()).max().item()
    norms = ((got["norm"] - want["norm"]).abs() / want["norm"]).tolist()
    norm = norms[0]
    worst, leaf = _relative(got["params"], want["params"])
    worst_leaves = _relative(got["params"], want["params"], 4)
    print(f"{tag} relative |diff| against one process: loss {loss:.3g}, "
          f"first gradient norm {norm:.3g} (the steps' "
          f"{[float(f'{n:.3g}') for n in norms]}), worst parameter leaf "
          f"{leaf:.3g} ({worst}; bar {PARALLEL_TOL}; the next "
          f"{[(k, float(f'{v:.3g}')) for k, v in worst_leaves[1:]]}); ms "
          f"per step {[round(t, 1) for t in got['ms']]} against one "
          f"process's {[round(t, 1) for t in want['ms']]}{extra}",
          flush=True)
    ok = max(loss, norm, leaf) < PARALLEL_TOL
    return {"loss": loss, "norm": norm, "leaf": leaf, "ms": got["ms"],
            "one_process_ms": want["ms"], "ok": ok,
            "failure": None if ok else f"{tag}: loss {loss}, gradient norm "
                                       f"{norm}, {worst} {leaf} (bar "
                                       f"{PARALLEL_TOL})"}


def _pipeline_run(device, dtype, layout=None, stages: int = 2) -> dict:
    """Two (or as many as the pipe axis has) DoubleSwin stages of swin_224's
    level 0 over PP_BATCH x 56 x 56 tokens, M = PP_MICROBATCHES, in
    *dtype* compute: through ``pipeline_apply`` on the grid's pipe axis
    (*layout*), or in one process as the sequential stack.  Returns the
    outputs of this process's samples, the loss, the stacked parameters'
    gradients (summed over the pipe axis), ms of the forward and backward,
    and K1's launches per tick of the forward and its backward's per tick
    of the backward."""
    import torch
    import torch.distributed as dist
    from torch.func import functional_call

    from medsegpretrainimagenet_tpu_torch import parallel
    from medsegpretrainimagenet_tpu_torch.models import blocks, swin
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    stages = layout[1] if layout else stages
    if layout is not None:
        parallel.create_grid(("data", "pipe"), layout)
    block = swin.DoubleSwinTransformerBlock(**PP_STAGE).to(device).train()
    params = []
    for i in range(stages):
        torch.manual_seed(100 + i)
        module = swin.DoubleSwinTransformerBlock(**PP_STAGE)
        params.append({k: v.to(device) for k, v in
                       module.named_parameters()})
    stacked = {k: v.detach().requires_grad_() for k, v in
               parallel.stack_stage_params(params).items()}
    generator = torch.Generator(device=device).manual_seed(3)
    side = PP_STAGE["img_size"] // PP_STAGE["patch_size"]
    tokens = (PP_BATCH, side * side, PP_STAGE["embed_dim"])
    x = torch.randn(tokens, device=device, generator=generator)
    target = torch.randn(tokens, device=device, generator=generator)
    if layout is not None and layout[0] > 1:
        data = parallel.grid().data
        x, target = (t.chunk(data.size)[data.index] for t in (x, target))

    def stage_fn(p, h):
        return functional_call(block, p, (h,))

    blocks.set_compute_dtype(dtype)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wa.window_attention_cuda.launches = 0
        wa.window_attention_backward_cuda.launches = 0
        if layout is None:
            y = x
            for i in range(stages):
                y = stage_fn({k: v[i] for k, v in stacked.items()}, y)
        else:
            y = parallel.pipeline_apply(
                stage_fn, stacked, x, num_microbatches=PP_MICROBATCHES,
                data_axis="data")
        ticks = PP_MICROBATCHES + stages - 1 if layout else stages
        launches = wa.window_attention_cuda.launches / ticks
        loss = ((y.float() - target) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        bwd_launches = wa.window_attention_backward_cuda.launches / ticks
    finally:
        blocks.set_compute_dtype(None)
    grads = {k: v.grad for k, v in stacked.items()}
    if layout is not None:
        for grad in grads.values():
            dist.all_reduce(grad, group=parallel.grid().inner.group)
        if layout[0] > 1:  # every data rank's share of the mean
            for grad in grads.values():
                dist.all_reduce(grad, group=parallel.grid().data.group)
                grad /= layout[0]
    return {"y": y.detach().float().cpu(), "loss": loss.item(),
            "grads": {k: v.double().cpu() for k, v in grads.items()},
            "ms": ms, "launches": launches, "bwd_launches": bwd_launches}


def _pipeline_held(tag: str, got: dict, want: dict, bar: float) -> dict:
    """Print and check a pipelined run against the sequential stack: the
    outputs of this process's samples (max |diff|, relative to their
    largest value in float32, absolute in bf16 as [k1] holds K1) and the
    worst stacked gradient (relative to its largest value)."""
    ref = want["y"][:got["y"].shape[0]]
    diff = (got["y"] - ref).abs().max().item()
    out = diff if bar == BF16_TOL else diff / ref.abs().max().item()
    worst, grad = _relative(got["grads"], want["grads"])
    print(f"{tag} outputs |diff| {out:.3g}, worst gradient {grad:.3g} "
          f"({worst}; bar {bar}); forward and backward "
          f"{got['ms']:.1f} ms against the sequential stack's "
          f"{want['ms']:.1f}; K1 launches per tick {got['launches']:g}, "
          f"its backward's {got['bwd_launches']:g} (the sequential stack: "
          f"{want['launches']:g} and {want['bwd_launches']:g} per stage)",
          flush=True)
    ok = out < bar and grad < bar and got["launches"] == 2 \
        and got["bwd_launches"] == 2
    return {"outputs": out, "gradient": grad, "ms": got["ms"],
            "sequential_ms": want["ms"], "launches": got["launches"],
            "ok": ok, "failure": None if ok else
            f"{tag} outputs {out}, {worst} {grad} (bar {bar}), "
            f"{got['launches']} K1 launches per tick and "
            f"{got['bwd_launches']} of its backward (2: one a Swin block)"}


def _parallel_cases(device) -> tuple:
    """[tp] and [sp]'s configs and batches: unet_256_train at batch
    TRAIN_BATCH, swin_224_train at TP_SWIN_BATCH without stochastic
    depth."""
    return (unet_256_train_config(), swin_224_train_config(rate=0.0),
            {k: v.to(device) for k, v in segmentation_batch(
                1, TRAIN_BATCH, TRAIN_SIZE, seed=0).items()},
            {k: v.to(device) for k, v in segmentation_batch(
                1, TP_SWIN_BATCH, 224, seed=1).items()})


def _pretrain_case(device) -> tuple:
    """[sp]'s pretraining case: unet_encoder_224_pretrain's model, loss and
    metrics on SP_PRETRAIN_BATCH random 224 x 224 images, stepped as the
    other [sp] cases are, by SGD with momentum at lr 1e-3, in place of its
    AdamW.  AdamW's first steps move each weight by about the learning
    rate in the sign of its gradient, so a float32 gradient element that
    another summation order (the bands') puts on the other side of zero
    moves a whole step the other way: a call read a worst leaf of 0.103
    after 3 AdamW steps with a first gradient norm within 2.8e-5, and a
    float32 CPU run on two bands reads 55 times SGD's parameter difference
    under AdamW.  (SGD at AdamW's lr 4e-3 read 2.9e-4 in the first-level
    convs, whose float32 gradient [sp]'s U-Net shows 1e-3 from float64.)
    The gradients themselves are held in float64 on the CPU
    (tests/test_torch_spatial_families.py)."""
    cfg = pretrain_config()
    cfg["training"]["optimizer"] = _segmentation_training(
        1e-3)["training"]["optimizer"]
    return cfg, {k: v.to(device) for k, v in classification_batch(
        SP_PRETRAIN_BATCH, 224, PRETRAIN_CLASSES, seed=2).items()}


def _whole_swin_levels(bands: int) -> list:
    """swin_224's token rows per level that run whole on *bands* bands:
    those that do not split into bands of whole 7-row windows."""
    return [rows for rows in (56, 28, 14, 7)
            if rows % bands or (rows // bands) % 7]


def parallel_references(path: Path, stages) -> None:
    """The one-process runs that [tp], [sp] and [pp] are held against, on
    this process's card (no process group, so no collective), written to
    *path*: unet_256_train's, swin_224_train's and [sp]'s pretraining
    steps, and the sequential DoubleSwin stacks of each count in *stages*,
    in float32 and bf16."""
    import torch

    # the ranks do not autotune cuDNN, and the references need not: the
    # pretraining model's autotuning took 23 s of a first step
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    with tf32_off():
        unet, swin_cfg, unet_batch, swin_batch = _parallel_cases("cuda")
        ref = {"unet": _grid_steps(unet, unet_batch, "cuda"),
               "swin": _grid_steps(swin_cfg, swin_batch, "cuda"),
               "pretrain": _grid_steps(*_pretrain_case("cuda"), "cuda")}
        for count in sorted(set(stages)):
            for dtype in (torch.float32, torch.bfloat16):
                ref[f"pp {count} {dtype}"] = _pipeline_run(
                    "cuda", dtype, stages=count)
    torch.backends.cudnn.benchmark = benchmark
    torch.save(ref, path)
    torch.cuda.empty_cache()


def parallel_worker(spec_path: str) -> int:
    """The process ``torchrun`` starts for [tp], [sp] and [pp]: ranks that
    share one card over gloo (``spec["shared"]``, asked for by name: NCCL
    refuses two ranks on one device) or one rank per card over NCCL.
    Every grid run is held against the one-process runs that the launching
    process wrote (:func:`parallel_references`; PARALLEL_TOL, float32, TF32
    off), [pp] also in bf16 (BF16_TOL, as [k1]).  Prints its lines from
    rank 0, and ends every rank at once when a check fails."""
    import os

    import torch
    import torch.distributed as dist

    from medsegpretrainimagenet_tpu_torch import parallel

    spec = json.loads(Path(spec_path).read_text())
    shared = spec["shared"]
    device = parallel.initialize_distributed(
        "cuda:0" if shared else None, backend="gloo" if shared else None)
    check(dist.get_backend() == ("gloo" if shared else "nccl"),
          f"[parallel] backend {dist.get_backend()} on {device}")
    main_rank = parallel.rank() == 0
    result = {}
    how = (f"{dist.get_world_size()} ranks sharing one card over gloo: a "
           f"correctness run, not a speed" if shared else
           f"{dist.get_world_size()} ranks, one per card, over NCCL")
    ref = torch.load(spec["references"], weights_only=False) \
        if main_rank else None

    def held(key, reading):
        result[key] = reading
        if not reading["ok"]:
            failures.append(reading["failure"])

    failures = []
    try:
        with tf32_off():
            unet, swin_cfg, unet_batch, swin_batch = _parallel_cases(device)
            for layout in spec["layouts"]:
                grid = f"{layout[0]} x {layout[1]}"
                tag = None if shared else f"tp {grid}"
                got = _grid_steps(unet, unet_batch, device, layout, "model",
                                  TP_MIN_CHANNELS, profile_tag=tag)
                if main_rank:
                    held(f"tp unet {grid}", _held(
                        f"[tp] unet_256_train data x model {grid} ({how}), "
                        f"min channels {TP_MIN_CHANNELS}, "
                        f"{100 * got['share']:.1f} % of the parameters "
                        f"sharded:", got, ref["unet"]))
                got = _grid_steps(swin_cfg, swin_batch, device, layout,
                                  "model", TP_MIN_CHANNELS)
                if main_rank:
                    held(f"tp swin {grid}", _held(
                        f"[tp] swin_224_train (batch {TP_SWIN_BATCH}, "
                        f"float32, stochastic depth off) data x model "
                        f"{grid}, {100 * got['share']:.1f} % sharded:",
                        got, ref["swin"],
                        f"; K1 launches per step {got['launches']:g}, its "
                        f"backward's {got['bwd_launches']:g}"))
                    result["tp_swin_train_launches"] = got["launches"]
                    result["tp_swin_train_bwd_launches"] = \
                        got["bwd_launches"]
                    if got["launches"] != 14 or got["bwd_launches"] != 14:
                        failures.append(
                            f"[tp] swin step: {got['launches']} K1 launches "
                            f"per step, {got['bwd_launches']} of its "
                            f"backward, not 14")
                tag = None if shared else f"sp {grid}"
                got = _grid_steps(unet, unet_batch, device, layout,
                                  "spatial", profile_tag=tag)
                if main_rank:
                    held(f"sp unet {grid}", _held(
                        f"[sp] unet_256_train data x spatial {grid} "
                        f"({TRAIN_SIZE // layout[1]} of {TRAIN_SIZE} rows a "
                        f"rank):", got, ref["unet"]))
                for mode, path in (("off", "K1"), ("on", "K2")):
                    got = _grid_steps(swin_cfg, swin_batch, device, layout,
                                      "spatial", fused_image=mode)
                    ours, other = (got["launches"], got["k2_launches"]) \
                        if path == "K1" else (got["k2_launches"],
                                              got["launches"])
                    ours_bwd, other_bwd = (
                        got["bwd_launches"], got["k2_bwd_launches"]) \
                        if path == "K1" else (got["k2_bwd_launches"],
                                              got["bwd_launches"])
                    if main_rank:
                        held(f"sp swin {path} {grid}", _held(
                            f"[sp] swin_224_train (batch {TP_SWIN_BATCH}, "
                            f"float32, stochastic depth off) data x spatial "
                            f"{grid} on the {path} path ({56 // layout[1]} "
                            f"of 56 token rows a rank at level 0; token "
                            f"rows {_whole_swin_levels(layout[1])} run "
                            f"whole) against one process on K1:", got,
                            ref["swin"], f"; {path} launches per rank per "
                            f"step {ours:g}, its backward's {ours_bwd:g}, "
                            f"the other kernels' {other:g} and "
                            f"{other_bwd:g}"))
                        result[f"sp_swin_{path.lower()}_launches"] = ours
                        result[f"sp_swin_{path.lower()}_bwd_launches"] = \
                            ours_bwd
                        if (ours, ours_bwd, other, other_bwd) \
                                != (14, 14, 0, 0):
                            failures.append(
                                f"[sp] swin step on {path}: {ours} launches "
                                f"per rank per step, {ours_bwd} of its "
                                f"backward (not 14), {other} and "
                                f"{other_bwd} of the other kernels")
                if 224 // 16 % layout[1] == 0:
                    # the encoder's 14-row bottom splits over 2 bands, not
                    # over 4
                    got = _grid_steps(*_pretrain_case(device), device,
                                      layout, "spatial")
                    if main_rank:
                        held(f"sp pretrain {grid}", _held(
                            f"[sp] unet_encoder_224_pretrain (batch "
                            f"{SP_PRETRAIN_BATCH}, float32) data x spatial "
                            f"{grid} ({224 // layout[1]} of 224 rows a rank, "
                            f"the pooled features and the head whole):",
                            got, ref["pretrain"]))
                for dtype, bar in ((torch.float32, PARALLEL_TOL),
                                   (torch.bfloat16, BF16_TOL)):
                    got = _pipeline_run(device, dtype, layout)
                    if main_rank:
                        result["pp_launches_per_tick"] = got["launches"]
                        result["pp_bwd_launches_per_tick"] = \
                            got["bwd_launches"]
                        held(f"pp {grid} {dtype}", _pipeline_held(
                            f"[pp] {layout[1]} DoubleSwin stages (swin_224 "
                            f"level 0: embed 96, 56 x 56 tokens, window 7, "
                            f"heads 3), data x pipe {grid}, M = "
                            f"{PP_MICROBATCHES}, batch {PP_BATCH}, "
                            f"{str(dtype)[6:]} ({how}):", got,
                            ref[f"pp {layout[1]} {dtype}"], bar))
            if not shared:
                # the data axis alone, every card on it, beside the layouts
                # above: what the grid adds to data parallelism
                world = dist.get_world_size()
                got = _grid_steps(unet, unet_batch, device, (world,))
                if main_rank:
                    held(f"dp unet {world}", _held(
                        f"[dp] unet_256_train data {world} ({how}):", got,
                        ref["unet"]))
        if main_rank:
            Path(spec["out"]).write_text(json.dumps(result))
            check(not failures, "; ".join(failures))
    except SystemExit as exc:
        # a failed check ends every rank at once: the launcher stops the
        # others when one exits, where they would wait in a collective
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(exc.code if isinstance(exc.code, int) else 1)
    finally:
        dist.destroy_process_group()
    return 0


def _parallel_launch(nproc: int, spec: dict) -> dict:
    """One ``torchrun --standalone --nproc_per_node NPROC`` of
    :func:`parallel_worker` on *spec*; prints the [tp], [sp], [pp] and
    profile lines of its rank 0 and returns what rank 0 wrote (K1's
    launches in the Swin step under tensor parallelism and per pipeline
    tick)."""
    import os

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        spec_path = Path(tmp) / "spec.json"
        result = Path(tmp) / "result.json"
        references = Path(tmp) / "references.pt"
        timed("parallel references", parallel_references, references,
              [layout[1] for layout in spec["layouts"]])
        spec_path.write_text(json.dumps({**spec, "out": str(result),
                                         "references": str(references)}))
        (Path(tmp) / "launch.py").write_text(_PARALLEL_LAUNCHER)
        env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(nproc), str(Path(tmp) / "launch.py"),
             str(ROOT), str(spec_path)], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=900)
        print("\n".join(line for line in out.stdout.splitlines()
                        if line.startswith(("[tp]", "[sp]", "[pp]", "[dp]",
                                            "[profile"))), flush=True)
        check(out.returncode == 0 and result.exists(),
              f"[parallel] torchrun of {nproc} ranks: exit "
              f"{out.returncode}; stderr tail:\n{out.stderr[-6000:]}")
        return json.loads(result.read_text())


def phase_parallel() -> dict:
    """[tp], [sp] and [pp] on this card: one torchrun launch of two ranks
    that share it over gloo (data x model, data x spatial and data x pipe
    1 x 2), each held against one process on the card."""
    return _parallel_launch(2, {"shared": True, "layouts": [[1, 2]]})


def main_parallel(cards: int = 4) -> int:
    """``chip_smoke.py --only parallel``: the parallel phases alone, one
    rank per card over NCCL on *cards* cards: [tp], [sp] and [pp] at data
    x inner 2 x 2 and 1 x 4 (profiled), then the CLI under ``torchrun
    --nproc_per_node 4`` with data parallelism (and the step timed), with
    ``tensor_parallel: 2`` and with ``spatial_sharding: 2``, each against
    the plain CLI.  Exits non-zero, naming the count, where fewer cards are
    visible."""
    if not (ROOT / "medsegpretrainimagenet_tpu_torch").is_dir():
        fail("run from a checkout: the package medsegpretrainimagenet_tpu_"
             "torch is not beside this script")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on the card")
    check(torch.cuda.device_count() >= cards,
          f"--only parallel needs {cards} CUDA cards; "
          f"{torch.cuda.device_count()} visible")
    card = card_line()
    print(card, flush=True)
    timed("build", phase_build)
    launches = timed("parallel", _parallel_launch, cards, {
        "shared": False, "layouts": [[2, cards // 2], [1, cards]]})
    timed("cli parallel", phase_ddp, None, [
        ("ddp", cards, {}, True),
        ("cli tp", cards, {"tensor_parallel": 2,
                           "tensor_parallel_min_channels": TP_MIN_CHANNELS},
         False),
        ("cli sp", cards, {"spatial_sharding": 2}, False)])
    print(card)
    print(json.dumps({"parallel": launches}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


#: [cli acdc]: a synthetic ACDC tree, ACDC_TRAIN + ACDC_TEST patients of
#: two frames of ACDC_SHAPE each (200 training and 100 validation slices
#: of 256 x 256 after the resize; 400 and 200 until the profiler trace of
#: the first epoch, most of the phase's time, was halved beside [remat]
#: and [ln half]), ACDC_EPOCHS epochs in one process (the resume under
#: --continued is [cli]'s: a process of its own took 33 s of the script's
#: time)
ACDC_TRAIN, ACDC_TEST, ACDC_SHAPE, ACDC_EPOCHS = 10, 5, (232, 256, 10), 3
ACDC_CLASSES = ("RV cavity", "myocardium", "LV cavity")
ACDC_METRICS = (MC + "DiceIndex", MC + "JaccardIndex",
                MC + "ModifiedHausdorffDistance", MC + "AUROC")
#: epoch_logs.csv's columns of the ACDC run, the JAX CLI's set
#: (tests/test_torch_cli.py holds the two CLIs' sets equal)
ACDC_EPOCH_COLUMNS = {"epoch", "learning_rate", "dice_loss",
                      "val_dice_loss"} | {
    f"{prefix}metrics/{name}" for prefix in ("", "val_") for name in (
        "dice_index_RV_cavity", "dice_index_myocardium",
        "dice_index_LV_cavity", "mean_dice_index", "mean_jaccard_index",
        "modified_hausdorff_distance", "area_under_roc")}


def write_acdc_tree(root: Path, seed: int = 0) -> None:
    """ACDC patient directories written with the port's save_nii: float32
    image volumes of ACDC_SHAPE (an LV disc in a myocardium ring and an RV
    crescent over noise) and their uint8 label volumes."""
    import numpy as np

    from medsegpretrainimagenet_tpu_torch.data.readers import save_nii

    rng = np.random.default_rng(seed)
    h, w, z = ACDC_SHAPE
    for part, n in (("training", ACDC_TRAIN), ("testing", ACDC_TEST)):
        for p in range(n):
            d = root / "ACDC" / part / f"patient{p:03d}"
            d.mkdir(parents=True)
            for frame in (1, 12):
                labels = acdc_labels(rng, z, h, w).transpose(1, 2, 0)
                img = 60 + 50 * labels + rng.normal(0, 15, labels.shape)
                stem = str(d / f"patient{p:03d}_frame{frame:02d}")
                save_nii(stem + ".nii.gz", img.astype(np.float32),
                         compresslevel=1)
                save_nii(stem + "_gt.nii.gz", np.ascontiguousarray(labels),
                         compresslevel=1)


def acdc_config(workdir: Path, epochs: int) -> dict:
    """The ACDC U-Net: the [train] U-Net at full width with a 4-channel
    softmax head (``config/downstream/acdc/unet.yaml``'s shape), batchwise
    multiclass Dice loss with the background, the multiclass Dice (with
    classwise columns), Jaccard, HD95 and AUROC, the confusion-matrix
    export, profiling and a watched val mean Dice; the rest as [cli]."""
    cfg = cli_config(workdir, epochs)
    cfg["meta"]["technical"]["model_evaluation"] = {
        "metric": "val_metrics/mean_dice_index", "mode": "max"}
    cfg["data"]["data"] = {"segmentation.datasets.ACDC": {
        "image_sizes": CLI_SIZE, "validate_on_test": True}}
    model = cfg["model"]["segmentation.models.UNet"]
    model["architecture"]["out_channel_size"] = len(ACDC_CLASSES) + 1
    model["final_activation"] = "softmax"
    cfg["training"]["loss"] = {"segmentation.losses.DiceLoss": {
        "batchwise": True, "include_background": True,
        "apply_softmax": False, "smoothing_term": 1e-5}}
    cfg["metrics"] = {"metrics": ACDC_METRICS, "calculation": {
        "number_of_classes": len(ACDC_CLASSES) + 1,
        "class_names": ACDC_CLASSES, "log_confusion_matrix": True}}
    return cfg


def _check_acdc_run(run: Path, epochs: int, module) -> list:
    """The ACDC run directory after *epochs* epochs; returns the rows."""
    import json

    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

    rows = _csv_rows(run / "epoch_logs.csv")
    check(len(rows) == epochs and set(rows[0]) == ACDC_EPOCH_COLUMNS,
          f"[cli acdc] epoch_logs.csv: {len(rows)} rows (want {epochs}), "
          f"columns {sorted(rows[0]) if rows else None}")
    steps = math.ceil(ACDC_TRAIN * 2 * ACDC_SHAPE[2] / CLI_BATCH)
    check(len(_csv_rows(run / "batch_logs.csv")) == steps * epochs,
          "[cli acdc] batch_logs.csv rows")
    for row in rows:
        check(all(math.isfinite(float(v)) for v in row.values()),
              f"[cli acdc] epoch row {row}")
    for split in ("train", "val"):
        path = run / "Confusion_matrices" / \
            f"{split}_confusion_matrix_epoch_{epochs}.json"
        check(path.is_file(), f"[cli acdc] {path.name} missing")
        matrix = json.loads(path.read_text())["matrix"]
        check(len(matrix) == 4 and sum(map(sum, matrix)) > 0,
              f"[cli acdc] {path.name}: {matrix}")
    plot = json.loads((run / "plots" / "dice_indices_plot.json")
                      .read_text())
    check(len(plot["Ys"]) == 3 and len(plot["Ys"][0]) == epochs,
          f"[cli acdc] dice_indices_plot.json: {plot['Ys']}")
    trace = run / "profile" / "trace" / "trace.json"
    check(trace.is_file() and trace.stat().st_size > 0,
          "[cli acdc] profile/trace/trace.json missing")
    # ACDC's reader has no test split (validate_on_test makes the testing
    # patients the val split): neither CLI writes test_logs.csv for it
    check(not (run / "test_logs.csv").exists(),
          "[cli acdc] test_logs.csv written for a reader without a test "
          "split")
    for name in ("last_model_state_dict.pt", "best_model_state_dict.pt"):
        module.load_state_dict(ckpt.load_params_file(run / name))
    return rows


def phase_cli_acdc(step_rate: float) -> None:
    """[cli acdc]: the ACDC multiclass U-Net through the experiment CLI in
    a process of its own, ACDC_EPOCHS epochs, on a synthetic tree written
    with the port's save_nii."""
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model

    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        workdir = Path(tmp)
        write_acdc_tree(workdir / "data")
        n_train = ACDC_TRAIN * 2 * ACDC_SHAPE[2]
        print(f"[cli acdc] synthetic ACDC tree: {ACDC_TRAIN} + {ACDC_TEST} "
              f"patients of two {ACDC_SHAPE} volumes ({n_train} + "
              f"{ACDC_TEST * 2 * ACDC_SHAPE[2]} slices) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        seconds = _run_cli(workdir, acdc_config(workdir, ACDC_EPOCHS))
        (exp,) = (workdir / "logs").glob("*/Experiment")
        run = exp / "run_1"
        cd = ConfigDict({"model": acdc_config(workdir, 1)["model"]})
        cd.expand()
        registry.fill_spec(cd, "model")
        module = registry.build(cd, key="model", wrapper=Model).module
        rows = _check_acdc_run(run, ACDC_EPOCHS, module)
        losses = [float(r["dice_loss"]) for r in rows]
        dice = [float(r["val_metrics/mean_dice_index"]) for r in rows]
        check(losses[-1] < losses[0] and dice[-1] > dice[0],
              f"[cli acdc] dice_loss {losses}, val mean Dice {dice}")
        last = rows[-1]
        print(f"[cli acdc] {ACDC_EPOCHS} epochs in {seconds:.1f} s of wall "
              f"time (process included): dice_loss {losses}, val mean Dice "
              f"{dice}; epoch {ACDC_EPOCHS} val: "
              + ", ".join(f"{k.split('/')[-1]} {float(v):.4f}"
                          for k, v in last.items()
                          if k.startswith("val_metrics/")), flush=True)
        epoch_times = _csv_rows(run / "profile" / "epoch_times.csv")
        step_times = _csv_rows(run / "profile" / "step_times.csv")
        for row, steps in zip(epoch_times, step_times):
            train_s = float(row["train_s"])
            rate = n_train / train_s
            print(f"[cli acdc] epoch {row['epoch']}: train {train_s:.3f} s "
                  f"= {rate:.1f} images/s ({100 * rate / step_rate:.1f} % "
                  f"of [train]'s {step_rate:.1f} step-only images/s), val "
                  f"{float(row['val_s']):.3f} s, checkpoints "
                  f"{float(row['ckpt_s']):.3f} s; device time per step "
                  f"mean {1e3 * float(steps['mean_s']):.2f} ms, p50 "
                  f"{1e3 * float(steps['p50_s']):.2f}, max "
                  f"{1e3 * float(steps['max_s']):.2f}", flush=True)
        trace = run / "profile" / "trace" / "trace.json"
        matrices = sorted(p.name for p in
                          (run / "Confusion_matrices").iterdir())
        print(f"[cli acdc] files: Confusion_matrices {matrices}, "
              f"plots/dice_indices_plot.json, profile/trace/trace.json "
              f"({trace.stat().st_size / 2 ** 20:.1f} MiB)", flush=True)
        del module
        torch.cuda.empty_cache()
    print(f"[cli acdc] {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# ImageNet pretraining of the U-Net encoder, and its transfer downstream
# ---------------------------------------------------------------------------

#: unet_encoder_224_pretrain, the JAX package's pretraining headline
#: (bench.py:575-632, :699-737): batch, crop side, stored side, classes
PRETRAIN_BATCH, PRETRAIN_SIZE, PRETRAIN_STORED, PRETRAIN_CLASSES = \
    64, 224, 256, 1000
#: [pretrain small]: AdamW's epsilon.  The gradient of a conv bias that
#: feeds a BatchNorm is zero up to rounding noise, which differs between
#: the card and the CPU; AdamW divides it by its own root mean square, so
#: at the default 1e-8 that noise moves those biases (and the running
#: means) by up to the learning rate per step on one device and not the
#: other.  1e-4 keeps the noise still and the real updates as they are.
PRETRAIN_SMALL_EPS = 1e-4
#: [cli pretrain]: a synthetic ImageNet store of 3 x 256 x 256 uint8 npy
#: files, PRETRAIN_CLI_CLASSES of the 1000 classes used, each with its own
#: tint, so that the loss has something to learn in two epochs (320
#: training files: the host's augmentation chain takes about 1.6 s a
#: batch of 64)
PRETRAIN_TRAIN, PRETRAIN_VAL, PRETRAIN_EPOCHS, PRETRAIN_CLI_CLASSES = \
    320, 128, 2, 20
#: epoch_logs.csv's columns for the pretraining config, the JAX CLI's set
#: (tests/test_torch_cli.py holds the two CLIs' sets equal)
PRETRAIN_EPOCH_COLUMNS = {
    "epoch", "learning_rate", "cross_entropy_loss", "metrics/accuracy",
    "metrics/area_under_roc", "val_cross_entropy_loss",
    "val_metrics/accuracy", "val_metrics/area_under_roc"}
#: [cli transfer]: the [cli] config, one epoch over this many images
TRANSFER_IMAGES = 256


def pretrain_config(classes: int = PRETRAIN_CLASSES, channels=None,
                    eps=None) -> dict:
    """``unet_encoder_224_pretrain``'s model, training and metrics: a
    ``FeedForwardModel`` of the U-Net encoder (depth 4, 64 -> 1024),
    adaptive average pooling, flatten and a 1000-way Linear; cross entropy
    with label smoothing 0.1; AdamW (0.9, 0.999), weight decay 0.05, its
    lr a linear warm-up to 0.004 into a cosine decay
    (``tests/test_pretrain_transfer_e2e.py:62-70``); Accuracy and AUROC on
    the labels.  *channels* cuts the width and depth."""
    encoder = {"in_channel_size": 3, "depth": 4}
    if channels:
        encoder.update(channels=tuple(channels), depth=len(channels) - 1)
    features = channels[-1] if channels else 1024
    adamw = {"betas": (0.9, 0.999), "weight_decay": 0.05, "learning_rate": {
        "optim.scheduler.LinearWarmupScheduler": {
            "base": 0.004, "warmup_length": 2, "iteration_unit": "batch",
            "main_scheduler": {"torch.optim.lr_scheduler.CosineAnnealingLR":
                               {"eta_min": 1e-6, "T_max": "auto"}}}}}
    if eps is not None:
        adamw["eps"] = eps
    return {
        "model": {"model.FeedForwardModel": {"layers": (
            {"segmentation.models.UNet_encoder": encoder},
            {"torch.nn.AdaptiveAvgPool2d": {"output_size": 1}},
            "torch.nn.Flatten",
            {"torch.nn.Linear": {"in_features": features,
                                 "out_features": classes}})}},
        "training": {
            "loss": {"classification.losses.CrossEntropyLoss": {
                "label_smoothing": 0.1, "label_type": "label"}},
            "optimizer": {"torch.optim.AdamW": adamw}},
        "metrics": {
            "metrics": (MC + "Accuracy", MC + "AUROC"),
            "calculation": {"number_of_classes": classes,
                            "label_type": "label", "apply_softmax": True,
                            "include_background_in_averages": True}},
    }


def classification_batch(n: int, size: int, classes: int, seed: int):
    """A fixed uint8 batch stack: random images and labels, (1, n, size,
    size, 3) and (1, n)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (1, n, size, size, 3), dtype=np.uint8)
    label = rng.integers(0, classes, (1, n)).astype(np.int32)
    return {"x": torch.from_numpy(x), "label": torch.from_numpy(label)}


def phase_pretrain_small():
    """A small float32 pretraining classifier (encoder depth 2, channels
    8-16-32, 10 classes) at 32 x 32: three cross-entropy + AdamW steps of
    one batch of 4 on the card and on the CPU from the same weights; loss,
    parameters and running statistics within TRAIN_TOL, TF32 off."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = pretrain_config(classes=10, channels=(8, 16, 32),
                          eps=PRETRAIN_SMALL_EPS)
    batch = classification_batch(4, 32, 10, seed=0)
    runs = []
    for device in ("cpu", "cuda"):
        model, state, calculator, step = build_trainer(cfg, device)
        metrics_state = calculator.init_state(device)
        losses = []
        for _ in range(3):
            state, metrics_state, per_batch = step(
                state, metrics_state, {k: v.to(device)
                                       for k, v in batch.items()})
            losses.append(per_batch["cross_entropy_loss"].item())
        runs.append((losses, {k: v.double().cpu() for k, v in
                              model.module.state_dict().items()}))
    (cpu_losses, cpu_state), (losses, state) = runs
    loss_err = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    state_err = {k: (v - cpu_state[k]).abs().max().item()
                 for k, v in state.items()}
    worst = max(state_err, key=state_err.get)
    stats_err = max(v for k, v in state_err.items() if "running" in k)
    check(loss_err < TRAIN_TOL and state_err[worst] < TRAIN_TOL,
          f"[pretrain small] card vs CPU: loss {loss_err}, {worst} "
          f"{state_err[worst]} (bar {TRAIN_TOL})")
    check(losses[-1] < losses[0], f"[pretrain small] losses {losses}")
    print(f"[pretrain small] f32 FeedForwardModel (encoder 8-16-32, 10 "
          f"classes), 3 CE + AdamW steps at 32x32, card vs CPU: max |diff| "
          f"loss {loss_err:.3g}, parameters and running statistics "
          f"{state_err[worst]:.3g} (running statistics {stats_err:.3g}; "
          f"bar {TRAIN_TOL}); loss {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)


def phase_pretrain_full() -> float:
    """unet_encoder_224_pretrain's train step at full width in bf16 on one
    fixed uint8 batch, as [train] times unet_256_train; then the same step
    with the on-card classification chain inside it, on a batch of the
    stored size.  Returns the plain step's median images/s."""
    import statistics as stats

    import torch

    from medsegpretrainimagenet_tpu_torch.models import blocks
    from medsegpretrainimagenet_tpu_torch.ops.augment import \
        make_classification_device_augment

    torch.backends.cudnn.benchmark = True
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = build_trainer(pretrain_config(),
                                                       "cuda")
        n_params = sum(p.numel() for p in model.module.parameters())
        batch = {k: v.cuda() for k, v in classification_batch(
            PRETRAIN_BATCH, PRETRAIN_SIZE, PRETRAIN_CLASSES, 0).items()}
        x0 = batch["x"][0, :1].float() / 255.0
        macs, first_macs = conv_macs(model.module, x0)
        flops = 2 * PRETRAIN_BATCH * (3 * macs - first_macs)
        bound_ms = 1e3 * flops / PEAK_OPS_PER_S["torch.bfloat16"]
        print(f"[pretrain] unet_encoder_224_pretrain: {n_params} parameters,"
              f" forward {macs / 1e9:.2f} GMAC per image (convs and the "
              f"Linear), train step {flops / 1e12:.3f} TFLOP at batch "
              f"{PRETRAIN_BATCH}: bound {bound_ms:.3f} ms (operations, bf16 "
              f"at 989 TFLOP/s)", flush=True)

        metrics_state = calculator.init_state("cuda")
        losses = []

        def run_steps(n, stack=batch, stepper=None):
            nonlocal state, metrics_state
            for _ in range(n):
                state, metrics_state, per_batch = (stepper or step)(
                    state, metrics_state, stack)
                losses.append(per_batch["cross_entropy_loss"])

        t0 = time.perf_counter()
        run_steps(3)
        torch.cuda.synchronize()
        print(f"[pretrain] warm-up, 3 steps: {time.perf_counter() - t0:.2f} "
              f"s", flush=True)
        losses.clear()
        torch.cuda.reset_peak_memory_stats()
        turns = _timed_turns(run_steps, "[pretrain] a host sync in a step")
        peak = torch.cuda.max_memory_allocated()
        values = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(values).all())
              and bool(values[-1] < values[0]),
              f"[pretrain] cross entropy {values.tolist()}")
        step_ms = [1e3 * t / TURN_STEPS for t in turns]
        rates = [PRETRAIN_BATCH * TURN_STEPS / t for t in turns]
        wall_ms = stats.median(step_ms)
        rate = stats.median(rates)
        print(f"[pretrain] bf16, batch {PRETRAIN_BATCH}, {PRETRAIN_SIZE}x"
              f"{PRETRAIN_SIZE}, {len(values)} steps on one batch with no "
              f"host sync (sync debug mode 'error'): cross entropy step 1 "
              f"{values[0].item():.4f}, step {len(values)} "
              f"{values[-1].item():.4f}", flush=True)
        print(f"[pretrain] images/s: median {rate:.1f} of "
              f"{[round(r, 1) for r in sorted(rates)]} ({TURNS} turns of "
              f"{TURN_STEPS} steps); {wall_ms:.3f} ms per step, "
              f"{100 * bound_ms / wall_ms:.1f} % of the {bound_ms:.3f} ms "
              f"bound; peak memory {peak / 2 ** 30:.2f} GiB", flush=True)
        profile_train(run_steps, 5, wall_ms, tag="pretrain")
        del model, state, metrics_state, step
        torch.cuda.empty_cache()

        # the on-card chain inside the step, from stored-size uint8 images
        chain = make_classification_device_augment(
            out_size=PRETRAIN_SIZE, n_classes=PRETRAIN_CLASSES,
            crop_scale=(0.8, 1.0), flip_probability=0.5,
            mixup_switch_probability=0.5, mixup_probability=0.8,
            erasing_probability=0.25)
        model, state, calculator, step = build_trainer(
            pretrain_config(), "cuda", device_augment=chain)
        metrics_state = calculator.init_state("cuda")
        stored = {k: v.cuda() for k, v in classification_batch(
            PRETRAIN_BATCH, PRETRAIN_STORED, PRETRAIN_CLASSES, 1).items()}
        run_steps(3, stored)
        losses.clear()
        turns = _timed_turns(lambda n: run_steps(n, stored),
                             "[pretrain] a host sync in the chain's step")
        chain_rates = [PRETRAIN_BATCH * TURN_STEPS / t for t in turns]
        values = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(values).all()),
              f"[pretrain] chain cross entropy {values.tolist()}")
        chain_rate = stats.median(chain_rates)
        print(f"[pretrain] with make_classification_device_augment in the "
              f"step (crop {PRETRAIN_STORED} -> {PRETRAIN_SIZE}, flip, "
              f"one-hot, mixup or cutmix, erasing), no host sync: median "
              f"{chain_rate:.1f} images/s of "
              f"{[round(r, 1) for r in sorted(chain_rates)]} against "
              f"{rate:.1f} plain ({100 * chain_rate / rate:.1f} %); cross "
              f"entropy {values[0].item():.4f} -> {values[-1].item():.4f}",
              flush=True)
        profile_train(lambda n: run_steps(n, stored), 5,
                      1e3 * PRETRAIN_BATCH / chain_rate,
                      tag="pretrain chain")
        return rate
    finally:
        blocks.set_compute_dtype(None)


def write_imagenet_store(root: Path, seed: int = 0) -> None:
    """An ImageNet store in the reader's layout (``bench.py:704-713``):
    channels-first uint8 ``.npy`` files and ``labels.json`` with classes
    1..1000, the validation files named ``val_*``.  PRETRAIN_CLI_CLASSES
    classes spread over the 1000 are used, each image noise under its
    class's tint."""
    import numpy as np

    rng = np.random.default_rng(seed)
    store = root / "imagenet"
    store.mkdir(parents=True)
    classes = rng.choice(PRETRAIN_CLASSES, PRETRAIN_CLI_CLASSES,
                         replace=False) + 1
    tints = rng.integers(0, 128, (PRETRAIN_CLI_CLASSES, 3, 1, 1))
    labels = {}
    for i in range(PRETRAIN_TRAIN + PRETRAIN_VAL):
        name = (f"train_{i:05d}.npy" if i < PRETRAIN_TRAIN
                else f"val_{i:05d}.npy")
        c = int(rng.integers(0, PRETRAIN_CLI_CLASSES))
        noise = rng.integers(0, 128, (3, PRETRAIN_STORED, PRETRAIN_STORED))
        np.save(store / name, (noise + tints[c]).astype(np.uint8))
        labels[name] = int(classes[c])
    (store / "labels.json").write_text(json.dumps(labels))


def pretrain_cli_config(workdir: Path, epochs: int) -> dict:
    """unet_encoder_224_pretrain through the CLI: the store read uint8
    (``uint8_transfer``), the train chain of ``bench.py:720-737``
    (RandomResizedCrop 224 of scale 0.8 to 1, flip, RandAugment, one-hot,
    MixupOrCutMix, RandomErasing), a 224 center crop for val, batch 64,
    bf16, the epoch-1 checkpoint and the confusion matrices of both
    epochs, profiling."""
    cfg = pretrain_config()
    cfg["metrics"]["calculation"].update(log_confusion_matrix=True,
                                         log_confusion_matrix_at=(1, 2))
    cfg.update({
        "experiment": {"number_of_epochs": epochs, "number_of_trials": 1},
        "meta": {"technical": {
            "seed": 777, "save_destination": str(workdir / "pretrain_logs"),
            "maximum_actual_batch_size": PRETRAIN_BATCH,
            "mixed_precision": True, "async_checkpointing": True,
            "profile": True, "export_plots_as": ("json",),
            "model_log_checkpoints": (1,)}},
        "data": {
            "data": {"classification.datasets.ImageNet": {
                "uint8_transfer": True}},
            "sampling": {"batch_size": PRETRAIN_BATCH},
            "transforms": {
                "train": (
                    {"torchvision.transforms.RandomResizedCrop": {
                        "size": PRETRAIN_SIZE, "scale": (0.8, 1.0)}},
                    "torchvision.transforms.RandomHorizontalFlip",
                    "classification.transforms.RandAugment",
                    {"classification.transforms.OneHotEncoding": {
                        "num_classes": PRETRAIN_CLASSES}},
                    {"classification.transforms.MixupOrCutMix": {
                        "mixup_params": {"distribution": "uniform",
                                         "probability": 0.8}}},
                    {"torchvision.transforms.RandomErasing": {"p": 0.25}}),
                "val": ({"torchvision.transforms.CenterCrop": {
                    "size": PRETRAIN_SIZE}},)}},
    })
    return cfg


def _pretrain_host_assembly(workdir: Path) -> float:
    """Host ms per assembled train batch of the CLI's own reader, chain and
    loader (lazy loads, the pairs' transforms, mixing, stacking)."""
    import itertools
    import os

    from medsegpretrainimagenet_tpu_torch.cli.run_experiment import \
        build_transform_pipelines
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.data import BalancedDataLoader
    from medsegpretrainimagenet_tpu_torch.data.readers import ImageNet

    os.environ["MST_DATA_DIR"] = str(workdir / "data")
    cd = ConfigDict(pretrain_cli_config(workdir, 1))
    cd.expand()
    pipeline, _, _, datapoints, _ = build_transform_pipelines(cd, seed=1)
    dataset = ImageNet(ConfigDict({"uint8_transfer": True}), seed=1)
    sampling = ConfigDict({"sampling": {"batch size": PRETRAIN_BATCH}})
    BalancedDataLoader.fill_kwargs(sampling["sampling"])
    loader = BalancedDataLoader(
        dataset.train, sampling["sampling/train"], bs=PRETRAIN_BATCH,
        actual_bs=PRETRAIN_BATCH, transforms=pipeline, seed=1,
        load_function=dataset.load_function,
        datapoints_per_sample=datapoints["train"])
    batches = iter(loader)
    next(batches)
    t0 = time.perf_counter()
    got = list(itertools.islice(batches, 3))
    ms = 1e3 * (time.perf_counter() - t0) / len(got)
    batch = got[0]
    check(batch["x"].shape == (PRETRAIN_BATCH, PRETRAIN_SIZE, PRETRAIN_SIZE,
                               3) and str(batch["x"].dtype) == "uint8"
          and batch["label"].shape == (PRETRAIN_BATCH, PRETRAIN_CLASSES),
          f"[cli pretrain] assembled batch {[(k, v.shape, v.dtype) for k, v in batch.items()]}")
    return ms


def phase_cli_pretrain(workdir: Path, step_rate: float) -> Path:
    """unet_encoder_224_pretrain through the experiment CLI in a process of
    its own, PRETRAIN_EPOCHS epochs on a synthetic store; the columns, the
    epoch checkpoint, the confusion matrices and the loss; the epochs'
    rates and the host's assembly time.  Returns the epoch-1 checkpoint."""
    import numpy as np

    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    write_imagenet_store(workdir / "data")
    print(f"[cli pretrain] synthetic ImageNet store: {PRETRAIN_TRAIN} + "
          f"{PRETRAIN_VAL} images of 3x{PRETRAIN_STORED}x{PRETRAIN_STORED} "
          f"uint8, {PRETRAIN_CLI_CLASSES} of {PRETRAIN_CLASSES} classes, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    seconds = _run_cli(workdir, pretrain_cli_config(workdir,
                                                    PRETRAIN_EPOCHS))
    (run,) = (workdir / "pretrain_logs").glob("*/Experiment/run_1")
    rows = _csv_rows(run / "epoch_logs.csv")
    check(len(rows) == PRETRAIN_EPOCHS
          and set(rows[0]) == PRETRAIN_EPOCH_COLUMNS,
          f"[cli pretrain] epoch_logs.csv: {len(rows)} rows, columns "
          f"{sorted(rows[0]) if rows else None}")
    for row in rows:
        check(all(math.isfinite(float(v)) for v in row.values()),
              f"[cli pretrain] epoch row {row}")
    losses = [float(r["cross_entropy_loss"]) for r in rows]
    check(losses[-1] < losses[0], f"[cli pretrain] cross entropy {losses}")
    encoder = run / "model_state_dict_epoch_1.pt"
    params, stats = ckpt.load_encoder_variables(str(encoder))
    check("stem_block.Conv_0.weight" in params and bool(stats),
          f"[cli pretrain] {encoder.name}: {len(params)} parameters, "
          f"statistics {bool(stats)}")
    for split in ("train", "val"):
        for epoch in range(1, PRETRAIN_EPOCHS + 1):
            path = run / "Confusion_matrices" / \
                f"{split}_confusion_matrix_epoch_{epoch}.json"
            check(path.is_file(), f"[cli pretrain] {path.name} missing")
            matrix = np.asarray(json.loads(path.read_text())["matrix"])
            check(matrix.shape == (PRETRAIN_CLASSES, PRETRAIN_CLASSES)
                  and matrix.sum() > 0,
                  f"[cli pretrain] {path.name}: {matrix.shape}")
    print(f"[cli pretrain] {PRETRAIN_EPOCHS} epochs in {seconds:.1f} s of "
          f"wall time (process included): cross entropy {losses}, accuracy "
          f"{[r['metrics/accuracy'] for r in rows]}, val accuracy "
          f"{[r['val_metrics/accuracy'] for r in rows]}, val AUROC "
          f"{[r['val_metrics/area_under_roc'] for r in rows]}; "
          f"{encoder.name} with {len(params)} encoder parameters and "
          f"{len(stats)} statistics; confusion matrices of epochs 1 and 2",
          flush=True)
    epoch_times = _csv_rows(run / "profile" / "epoch_times.csv")
    step_times = _csv_rows(run / "profile" / "step_times.csv")
    for row, steps in zip(epoch_times, step_times):
        train_s = float(row["train_s"])
        rate = PRETRAIN_TRAIN / train_s
        print(f"[cli pretrain] epoch {row['epoch']}: train {train_s:.3f} s = "
              f"{rate:.1f} images/s ({100 * rate / step_rate:.1f} % of "
              f"[pretrain]'s {step_rate:.1f} step-only images/s), val "
              f"{float(row['val_s']):.3f} s, checkpoints "
              f"{float(row['ckpt_s']):.3f} s, confusion matrices "
              f"{float(row.get('cm_export_s', 'nan')):.3f} s; device time per"
              f" step mean {1e3 * float(steps['mean_s']):.2f} ms, p50 "
              f"{1e3 * float(steps['p50_s']):.2f}", flush=True)
    assembly_ms = _pretrain_host_assembly(workdir)
    print(f"[cli pretrain] host assembly {assembly_ms:.1f} ms per batch of "
          f"{PRETRAIN_BATCH} ({2 * PRETRAIN_BATCH} lazy loads and chains up "
          f"to MixupOrCutMix, mixing, erasing, stacking), "
          f"{1e3 * PRETRAIN_BATCH / assembly_ms:.1f} images/s of host "
          f"supply", flush=True)
    return encoder


def phase_cli_transfer(workdir: Path, encoder: Path) -> None:
    """The [cli] COVID-QU config, one epoch over TRANSFER_IMAGES images,
    its U-Net's encoder from [cli pretrain]'s epoch-1 checkpoint
    (``weight_init/encoder``, not strict).  In this process, before any
    step: the encoder's parameters and BatchNorm statistics equal the
    checkpoint's and the decoder is the random init's.  Then the CLI in a
    process of its own: exit 0, the load announced, the loss falling."""
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

    write_covidqu_tree(workdir / "data", images=TRANSFER_IMAGES)
    cfg = cli_config(workdir, 1, measured=False)
    cfg["meta"]["technical"]["save_destination"] = str(
        workdir / "transfer_logs")
    random_init = {"torch.nn.init.kaiming_normal_": {"nonlinearity": "relu"}}
    cfg["model"]["segmentation.models.UNet"]["weight_init"] = {
        "random": random_init,
        "encoder": {"weights": str(encoder), "strict": False,
                    "pretrained_encoder": True}}

    def built(model_cfg):
        cd = ConfigDict({"model": model_cfg})
        cd.expand()
        registry.fill_spec(cd, "model")
        inner = cd["model"].value()
        Model.fill_weight_init_kwargs(inner)
        model = registry.build(cd, key="model", wrapper=Model)
        model.init(777)
        model.init_weight(inner, torch.Generator().manual_seed(778))
        return model.module.state_dict()

    got = built(cfg["model"])
    plain = json.loads(json.dumps(cfg["model"]))
    plain["segmentation.models.UNet"]["weight_init"] = random_init
    fresh = built(plain)
    params, stats = ckpt.load_encoder_variables(str(encoder))
    loaded = {**params, **stats}
    enc = [k for k in got if k.startswith("enc.")
           and not k.endswith("num_batches_tracked")]
    dec = [k for k in got if k.startswith("dec.")]
    check(all(torch.equal(got[k], loaded[k[4:]]) for k in enc),
          "[cli transfer] the U-Net's encoder differs from the checkpoint's")
    check(any(not torch.equal(got[k], fresh[k]) for k in enc)
          and all(torch.equal(got[k], fresh[k]) for k in dec),
          "[cli transfer] the decoder changed, or the encoder did not")
    print(f"[cli transfer] before the first step: {len(enc)} encoder "
          f"tensors (parameters and BatchNorm statistics) equal "
          f"{encoder.name}'s; the {len(dec)} decoder tensors are the random "
          f"init's", flush=True)

    seconds, out = _cli_process(workdir, cfg)
    marks = [m for m in ENVELOPE_MARKS if m in out.stderr]
    check(out.returncode == 0 and not marks
          and "Successfully initialised encoder" in out.stdout,
          f"[cli transfer] exit {out.returncode}, envelope marks {marks}; "
          f"stderr tail:\n{out.stderr[-4000:]}")
    (run,) = (workdir / "transfer_logs").glob("*/Experiment/run_1")
    batches = [float(r["dice_loss"])
               for r in _csv_rows(run / "batch_logs.csv")]
    head, tail = statistics.mean(batches[:4]), statistics.mean(batches[-4:])
    check(len(batches) == TRANSFER_IMAGES // CLI_BATCH and tail < head,
          f"[cli transfer] dice_loss per batch {batches}")
    rows = _csv_rows(run / "epoch_logs.csv")
    print(f"[cli transfer] 1 epoch of {TRANSFER_IMAGES} images in "
          f"{seconds:.1f} s of wall time (process and cuDNN autotuning "
          f"included), encoder from {encoder.name}: dice_loss over the first "
          f"4 batches {head:.4f}, the last 4 {tail:.4f}; val Dice "
          f"{rows[0]['val_metrics/dice_index_threshold_0.5']}", flush=True)


#: robustness_224, the JAX package's on-chip sweep (tools/robustness_tpu.py:
#: 40-131): probes of 1 x 224 x 224, a forward batch of 32, the sweep axes
ROB_PROBES, ROB_SIZE = 32, 224
ROB_METRICS = ("cosine_distance", "l2_loss", "inv_pearson_corr")
ROB_MARGINS = (0.0, 0.25, 0.5, 0.75, 1.0)
ROB_LEVELS = (1, 2, 3, 4)
#: levels per encoder: [*skips, final] has 5 entries for the U-Net encoder
#: and the ResNet, 4 for the Swin encoder, so level 4 is skipped for it
ROB_ENCODER_LEVELS = {"u-net_encoder": [1, 2, 3, 4], "resnet50": [1, 2, 3, 4],
                      "swin_transformer": [1, 2, 3]}
ROB_ROWS = len(ROB_METRICS) * len(ROB_MARGINS) * 2 * sum(
    len(v) for v in ROB_ENCODER_LEVELS.values())
#: the JAX CLI's CSV header (robustness/sweep.py:24-26), written out: this
#: script imports nothing of the JAX package
ROB_CSV_COLUMNS = ["dataset", "metric", "margin", "encoder",
                   "pretraining_scheme", "pooled", "level",
                   "pretraining_length", "robustness"]
#: the Swin encoder's attention calls per forward at 224: (level, heads,
#: windows per image, SW-MSA calls, W-MSA calls); the bottom level (7 x 7
#: tokens, one window) has no shift
ROB_ATTENTION = [(0, 3, 64, 1, 1), (1, 6, 16, 1, 1), (2, 12, 4, 1, 1),
                 (3, 24, 1, 0, 2)]
ROB_K1_PER_FORWARD = sum(m + p for _, _, _, m, p in ROB_ATTENTION)
#: [robustness small], card against CPU with TF32 off: the levels relative
#: to their largest value, the rows absolute
ROB_LEVEL_TOL, ROB_ROW_TOL = 1e-4, 1e-5
#: kernel-name fragments -> the group of the Swin encoder's float32 forward
#: they belong to, for [profile robustness swin]; the first match wins
_SWIN_GROUPS = (
    ("window_attention", "attention (K1)"),
    ("image_attention", "attention (K2)"),
    ("layer_norm", "LayerNorm"),
    ("fprop", "conv (PatchEmbed)"), ("conv", "conv (PatchEmbed)"),
    ("roll", "copies and permutes"), ("copy", "copies and permutes"),
    ("catarray", "copies and permutes"), ("index", "copies and permutes"),
    ("gemm", "matmuls"), ("nvjet", "matmuls"), ("cutlass", "matmuls"),
    ("xmma", "matmuls"), ("sm90", "matmuls"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise (GELU, adds, scales, casts)"))


def robustness_encoders(size: int) -> list:
    """The three encoder families of ``tools/robustness_tpu.py:40-81`` at
    probe resolution *size*: the U-Net encoder (64 -> 1024), ResNet-50 v1
    without conv biases, and the Swin encoder (patch 4, window 7, 96-768,
    heads 3-24, depth 3, width 2, stochastic depth 0.1).  Below 224 the
    Swin encoder takes the smoke geometry (depth 1, 96-192, heads 3-6)."""
    swin_depth, swin_channels, swin_heads = 3, [96, 192, 384, 768], \
        [3, 6, 12, 24]
    if size < 224:
        swin_depth, swin_channels, swin_heads = 1, [96, 192], [3, 6]
    return [
        {"name": "u-net_encoder", "pretraining_scheme": "simple_training",
         "pretraining_length": 0,
         "model": {"segmentation.models.UNet_encoder": {
             "in_channel_size": 3}}},
        {"name": "resnet50", "pretraining_scheme": "simple_training",
         "pretraining_length": 0,
         "model": {"classification.models.DeepResNet": {
             "bias": False, "version": "v1"}}},
        {"name": "swin_transformer",
         "pretraining_scheme": "simple_training", "pretraining_length": 0,
         "model": {"segmentation.models.UNet_encoder": {
             "in_channel_size": 3, "channels": swin_channels,
             "change_channel_in_block": False, "depth": swin_depth,
             "width": 2, "trainable_downsampling": True,
             "linear_channel_mapping": True, "stochastic_depth_rate": 0.1,
             "basic_block": {
                 "segmentation.models.blocks.SwinTransformerBlock": {
                     "img_size": size, "patch_size": 4,
                     "num_heads_layers": swin_heads}},
             "downsampling": {"segmentation.models.blocks.PatchMerging": {
                 "norm_layer": "torch.nn.LayerNorm"}},
             "stem": {"segmentation.models.blocks.PatchEmbed": {
                 "patch_size": 4}}}}},
    ]


def robustness_config(output: Path, encoders: list) -> dict:
    """robustness_224's sweep config (``tools/robustness_tpu.py:117-131``)."""
    return {
        "data": {"COVID-QU": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": ROB_SIZE,
            "validate_on_test": True}}},
        "probe_images": ROB_PROBES, "encoders": encoders,
        "metrics": list(ROB_METRICS), "margins": list(ROB_MARGINS),
        "levels": list(ROB_LEVELS), "pooled": [False, True],
        "batch_size": ROB_PROBES, "output": str(output), "seed": 0}


def write_probe_tree(root: Path, seed: int = 0) -> None:
    """The synthetic COVID-QU probe tree of ``tools/robustness_tpu.py:
    104-114``: ROB_PROBES uint8 noise images of 1 x 224 x 224 (and 2 test
    images), a centred square as the mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = root / "COVID_QU" / "Inf_segm" / "data arrays" / "COVID-19"
    for part, n in (("train and val", ROB_PROBES), ("test", 2)):
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy", rng.integers(0, 256, (n, 1, ROB_SIZE,
                                                      ROB_SIZE),
                                             dtype=np.uint8))
        masks = np.zeros((n, 1, ROB_SIZE, ROB_SIZE), np.uint8)
        masks[:, :, ROB_SIZE // 4:-ROB_SIZE // 4,
              ROB_SIZE // 4:-ROB_SIZE // 4] = 2
        np.save(d / "inf_masks.npy", masks)


def reference_names(state: dict, family: str) -> dict:
    """A port encoder state dict (Swin or ResNet v1) under the reference's
    torch module names, prefixed ``layers.0.`` as a released pretraining
    checkpoint holds them: the inverse of ``train.torch_mapping``."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if family == "resnet":
            if parts[0] in ("stem_conv", "stem_bn"):
                key = f"stem.{0 if parts[0] == 'stem_conv' else 1}." \
                      f"{parts[1]}"
            else:
                kind, k = parts[3].split("_")
                key = (f"levels.{parts[1]}.{parts[2]}."
                       f"{'conv' if kind == 'Conv' else 'bn'}{int(k) + 1}."
                       f"{parts[4]}")
        elif parts[0] == "stem_block":
            child = {"Conv_0": "proj", "LayerNorm_0": "norm_layer"}[parts[1]]
            key = f"first_block.{child}.{parts[2]}"
        elif parts[0] == "downsamples":
            child = {"Dense_0": "reduction", "LayerNorm_0": "norm"}[parts[2]]
            key = f"down_layers.{parts[1]}.downsampl.{child}.{parts[3]}"
        else:
            module, rest = (f"down_layers.{parts[1]}.conv{parts[2]}",
                            parts[3:]) if parts[0] == "level_convs" \
                else (f"bottom_block.conv{parts[1]}", parts[2:])
            if rest[0] == "mlp":
                rest = ["mlp", {"Dense_0": "fc1", "Dense_1": "fc2"}[rest[1]],
                        rest[2]]
            key = f"{module}.{'.'.join(rest)}"
        out[f"layers.0.{key}"] = value
    return out


def _relative_max(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    return ((got.float().cpu() - ref.float().cpu()).abs().max()
            / ref.float().abs().max().clamp_min(1e-12)).item()


def phase_robustness_small():
    """A small sweep on the card against the same sweep on the CPU, TF32
    off, the same weights and the same injected draws: a narrow U-Net
    encoder, a narrow ResNet v1 bottleneck and the Swin encoder at the
    smoke geometry of ``tools/robustness_tpu.py:49-50``, at 112 x 112.
    Levels and rows card vs CPU; K1 against its plain version on the
    inputs the Swin encoder gives it."""
    import copy

    import numpy as np
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.models import swin
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.robustness import eval as rob_eval
    from medsegpretrainimagenet_tpu_torch.robustness import sweep
    from medsegpretrainimagenet_tpu_torch.robustness.__main__ import (
        build_encoders)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    size, n = 112, 8
    encoders = robustness_encoders(size)
    encoders[0]["model"]["segmentation.models.UNet_encoder"].update(
        channels=[16, 32, 64, 128], depth=3)
    encoders[1]["model"]["classification.models.DeepResNet"].update(
        channel_sizes=[64, 128, 256], widths=[1, 1, 1],
        base_channel_size=16)
    probes = np.random.default_rng(5).random((n, size, size, 1)).astype(
        np.float32)
    cpu = build_encoders(ConfigDict({"encoders": encoders}),
                         {"probe": probes}, 0, torch.device("cpu"))
    card = [dict(e, module=copy.deepcopy(e["module"]).cuda()) for e in cpu]
    draws = sweep.dataset_draws(0, 0)
    view = rob_eval.apply_color_jitter(torch.from_numpy(probes), draws[0])
    for c, g in zip(cpu, card):
        x = sweep.adapt_channels(view, c["in_channels"])
        ref = rob_eval.collect_levels(c["module"], x, batch_size=n)
        wa.window_attention_cuda.launches = 0
        got = rob_eval.collect_levels(g["module"], x.cuda(), batch_size=n)
        errs = [_relative_max(a, b) for a, b in zip(got, ref)]
        check(max(errs) < ROB_LEVEL_TOL,
              f"[robustness small] {c['name']}: levels card vs CPU, max "
              f"|diff| / max |level| {errs} (bar {ROB_LEVEL_TOL})")
        print(f"[robustness small] {c['name']} at {size}x{size}, {n} "
              f"probes: {len(got)} levels, card vs CPU max |diff| / max "
              f"|level| {max(errs):.3g} (bar {ROB_LEVEL_TOL}); K1 launches "
              f"{wa.window_attention_cuda.launches}", flush=True)
    check(wa.window_attention_cuda.launches == 4,
          f"[robustness small] the Swin encoder launched K1 "
          f"{wa.window_attention_cuda.launches} times, not 4")

    # K1 against its plain version on the inputs the Swin encoder gives it
    calls = []
    core = swin.window_attention_core

    def recording(q, k, v, bias, mask, scale, **dispatch):
        calls.append((q, k, v, bias, mask, scale))
        return core(q, k, v, bias, mask, scale, **dispatch)

    x = sweep.adapt_channels(view, 3).cuda()
    swin.window_attention_core = recording
    try:
        kernel_levels = rob_eval.collect_levels(card[2]["module"], x,
                                                batch_size=n)
    finally:
        swin.window_attention_core = core
    readings = []
    for q, k, v, bias, mask, scale in calls:
        def plain(bias, mask, q=q, k=k, v=v, scale=scale):
            return wa.window_attention_core(q, k, v, bias, mask, scale,
                                            force="torch")
        readings.append(hold(f"[robustness small] K1 f32 on the Swin "
                             f"encoder's {tuple(q.shape)} input",
                             wa.window_attention_cuda(q, k, v, bias, mask,
                                                      scale),
                             plain(bias, mask), plain, bias, mask))
    swin.window_attention_core = functools.partial(core, force="torch")
    try:
        plain_levels = rob_eval.collect_levels(card[2]["module"], x,
                                               batch_size=n)
    finally:
        swin.window_attention_core = core
    pinned = max(_relative_max(a, b)
                 for a, b in zip(kernel_levels, plain_levels))
    check(pinned < ROB_LEVEL_TOL,
          f"[robustness small] Swin levels, K1 vs plain attention: "
          f"{pinned}")
    print(f"[robustness small] K1 f32 against its plain version on the "
          f"Swin encoder's {len(calls)} calls "
          f"{sorted({tuple(c[0].shape) for c in calls})}: max "
          f"{max(r[0] for r in readings):.3g} (bar {F32_TOL}), mean "
          f"{max(r[1] for r in readings):.3g} (bar "
          f"{MEAN_TOL['torch.float32']}; a misaddressed table reads "
          f">= {min(r[2] for r in readings):.3g}); Swin levels with the "
          f"attention pinned to plain vs K1: {pinned:.3g} relative",
          flush=True)

    axes = dict(metrics=ROB_METRICS, margins=ROB_MARGINS, levels=ROB_LEVELS,
                pooled=(False, True), batch_size=n)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the Swin encoder's skipped levels
        ref_rows = sweep.run_sweep(cpu, {"probe": probes},
                                   draws={"probe": draws}, **axes)
        rows = sweep.run_sweep(card, {"probe": probes},
                               draws={"probe": draws}, **axes)
    diff = max(abs(a["robustness"] - b["robustness"])
               for a, b in zip(rows, ref_rows))
    check(len(rows) == len(ref_rows) == len(ROB_METRICS) * len(ROB_MARGINS)
          * 2 * (3 + 3 + 1)
          and all(math.isfinite(r["robustness"]) for r in rows)
          and diff < ROB_ROW_TOL,
          f"[robustness small] rows card vs CPU: {len(rows)} rows, max "
          f"|diff| {diff} (bar {ROB_ROW_TOL})")
    print(f"[robustness small] {len(rows)} rows card vs CPU (TF32 off, the "
          f"same draws): max |diff| {diff:.3g} (bar {ROB_ROW_TOL})",
          flush=True)


def _attention_f32_per_forward() -> dict:
    """K1 and K2 in float32 at the Swin encoder's shapes for ROB_PROBES
    probes at 224, each against its plain version (the [k1]/[k2] bars),
    timed L2-cold and warm beside its plain version, SDPA in float32 (the
    library yardstick, with bias and mask as one additive mask; for K2 with
    the layout permutes) and the bound; summed over the calls of one
    encoder forward."""
    import torch
    import torch.nn.functional as F

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import (
        device_ms, input_copies)

    gen = torch.Generator().manual_seed(7)
    scale = HEAD_DIM ** -0.5
    dtype = torch.float32
    total = dict.fromkeys(("k1_ms", "k1_warm_ms", "k1_plain_ms", "k1_sdpa_ms",
                           "k2_ms", "k2_warm_ms", "k2_plain_ms", "k2_sdpa_ms",
                           "bytes_ms", "ops_ms", "k1_err", "k2_err",
                           "k1_mean_err", "k2_mean_err"), 0.0)
    for level, heads, n_w, n_masked, n_plain in ROB_ATTENTION:
        for masked in (False, True):
            calls = n_masked if masked else n_plain
            if calls == 0:
                continue
            q, k, v, bias, mask = _k1_inputs(level, heads, n_w, masked,
                                             dtype, gen, batch=ROB_PROBES)

            def plain(bias, mask):
                return wa.window_attention_core(q, k, v, bias, mask, scale,
                                                force="torch")

            def k1(q, k, v):
                return wa.window_attention_cuda(q, k, v, bias, mask, scale)

            err, mean_err, _ = hold(f"[robustness] K1 f32 level {level}",
                                    k1(q, k, v), plain(bias, mask), plain,
                                    bias, mask)
            full = _sdpa_mask(bias, mask, q.shape[0], dtype)
            copies = input_copies(q, k, v)
            t = {"k1_ms": device_ms(k1, copies),
                 "k1_warm_ms": device_ms(k1, copies[:1]),
                 "k1_plain_ms": device_ms(
                     lambda q, k, v: wa.window_attention_torch(
                         q, k, v, bias, mask, scale), copies),
                 "k1_sdpa_ms": device_ms(
                     lambda q, k, v: F.scaled_dot_product_attention(
                         q, k, v, attn_mask=full, scale=scale), copies)}
            del copies
            t_bytes, t_ops = _k1_bound_ms(q, bias, mask)

            res = 56 // 2 ** level
            qkv = torch.randn(ROB_PROBES, res, res, 3 * heads * HEAD_DIM,
                              generator=gen).cuda()

            def plain_image(bias, mask):
                return wa.fused_image_window_attention(
                    qkv, bias, mask, scale, WINDOW, force="torch")

            def k2(qkv):
                return wa.image_attention_cuda(qkv, bias, mask, scale, WINDOW)

            err2, mean_err2, _ = hold(f"[robustness] K2 f32 level {level}",
                                      k2(qkv), plain_image(bias, mask),
                                      plain_image, bias, mask)
            copies = input_copies(qkv)
            t.update(
                k2_ms=device_ms(k2, copies),
                k2_warm_ms=device_ms(k2, copies[:1]),
                k2_plain_ms=device_ms(lambda qkv: wa.image_attention_torch(
                    qkv, bias, mask, scale, WINDOW), copies),
                k2_sdpa_ms=device_ms(lambda qkv: _sdpa_image_path(
                    qkv, full, scale), copies))
            del copies
            bound = max(t_bytes, t_ops)
            print(f"[robustness] attention f32 level {level} B_="
                  f"{q.shape[0]} H={heads} {'SW-MSA' if masked else 'W-MSA '}"
                  f", L2-cold: K1 {t['k1_ms']:.4f} ms (warm "
                  f"{t['k1_warm_ms']:.4f}), plain {t['k1_plain_ms']:.4f}, "
                  f"SDPA f32 {t['k1_sdpa_ms']:.4f}; K2 {t['k2_ms']:.4f} "
                  f"(warm {t['k2_warm_ms']:.4f}), plain "
                  f"{t['k2_plain_ms']:.4f}, permute+SDPA f32+permute "
                  f"{t['k2_sdpa_ms']:.4f}; bound {bound:.4f} "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}; K1 "
                  f"{100 * bound / t['k1_ms']:.1f} %, K2 "
                  f"{100 * bound / t['k2_ms']:.1f} % of it); |kernel - "
                  f"plain| K1 max {err:.3g} mean {mean_err:.3g}, K2 max "
                  f"{err2:.3g} mean {mean_err2:.3g}; calls/forward={calls}",
                  flush=True)
            for key, value in t.items():
                total[key] += calls * value
            total["bytes_ms"] += calls * t_bytes
            total["ops_ms"] += calls * t_ops
            for key, value in (("k1_err", err), ("k2_err", err2),
                               ("k1_mean_err", mean_err),
                               ("k2_mean_err", mean_err2)):
                total[key] = max(total[key], value)
    total["bound_ms"] = max(total["bytes_ms"], total["ops_ms"])
    total["bound_by"] = "bytes" if total["bytes_ms"] >= total["ops_ms"] \
        else "operations"
    return total


def phase_robustness(workdir: Path, encoder: Path) -> int:
    """robustness_224 at full width with torch's default float32 settings
    (TF32 for cuDNN's convolutions, none for matmuls, no cuDNN
    autotuning), as the sweep CLI runs:
    ms per forward of each encoder, the Swin encoder's K1 launches (and K2
    under ``set_fused_image_mode("on")``), K1 and K2 in float32 against
    plain, SDPA and the bound, the in-process sweep with its launches and
    host reads, then the CLI in a process of its own with the
    ``u-net_encoder`` from *encoder* ([cli pretrain]'s epoch-1 checkpoint)
    and reference-named weight files for the other two.  Returns the
    launches of K1 in the in-process sweep and of K2 in the same sweep
    under ``set_fused_image_mode("on")``, and the float32 attention sums of
    :func:`_attention_f32_per_forward`."""
    import os
    import warnings

    import torch

    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, dump_yaml
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.ops.kernel_ab import device_ms
    from medsegpretrainimagenet_tpu_torch.robustness import eval as rob_eval
    from medsegpretrainimagenet_tpu_torch.robustness import sweep
    from medsegpretrainimagenet_tpu_torch.robustness.__main__ import (
        build_encoders, load_probes)
    from medsegpretrainimagenet_tpu_torch.train.checkpoint import (
        save_params_file)

    # torch's defaults, as the sweep CLI runs (no cuDNN autotuning)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    write_probe_tree(workdir / "rob_data")
    cfg = ConfigDict(robustness_config(workdir / "random.csv",
                                       robustness_encoders(ROB_SIZE)))
    os.environ["MST_DATA_DIR"] = str(workdir / "rob_data")
    try:
        datasets = load_probes(cfg, 0, ROB_PROBES)
    finally:
        del os.environ["MST_DATA_DIR"]
    encoders = build_encoders(cfg, datasets, 0, torch.device("cuda"))
    probes = torch.from_numpy(datasets["COVID-QU"]).cuda()
    check(tuple(probes.shape) == (ROB_PROBES, ROB_SIZE, ROB_SIZE, 1),
          f"[robustness] probes {tuple(probes.shape)}")
    view = rob_eval.apply_color_jitter(probes, sweep.dataset_draws(0, 0)[0])
    forward_ms = {}
    for enc in encoders:
        x = sweep.adapt_channels(view, enc["in_channels"])
        module = enc["module"]
        params = sum(p.numel() for p in module.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = device_ms(lambda x: rob_eval.collect_levels(module, x,
                                                         ROB_PROBES),
                       [(x,)], runs=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        forward_ms[enc["name"]] = ms
        print(f"[robustness] {enc['name']} ({params:,} parameters, input "
              f"{tuple(x.shape)}) f32 forward of {ROB_PROBES} probes with "
              f"every level: {ms:.3f} ms (device time, CUDA events, median "
              f"of 5 runs of 20) = "
              f"{1e3 * ROB_PROBES / ms:.1f} probes/s, peak memory "
              f"{peak:.2f} GiB", flush=True)

    swin_enc = encoders[2]
    x = sweep.adapt_channels(view, swin_enc["in_channels"])
    paths = {}
    for mode in ("off", "on"):
        wa.window_attention_cuda.launches = 0
        wa.image_attention_cuda.launches = 0
        ops.set_fused_image_mode(mode)
        try:
            paths[mode] = rob_eval.collect_levels(swin_enc["module"], x,
                                                  ROB_PROBES)
        finally:
            ops.set_fused_image_mode("off")
        k1, k2 = (wa.window_attention_cuda.launches,
                  wa.image_attention_cuda.launches)
        want = (ROB_K1_PER_FORWARD, 0) if mode == "off" \
            else (0, ROB_K1_PER_FORWARD)
        check((k1, k2) == want,
              f"[robustness] Swin encoder forward, fused image mode {mode}:"
              f" K1 {k1}, K2 {k2} launches (want {want})")
    err = max(_relative_max(a, b) for a, b in zip(paths["on"], paths["off"]))
    check(err < F32_TOL, f"[robustness] Swin levels, K2 path vs K1 path: "
                         f"{err} relative")
    print(f"[robustness] swin_transformer forward: {ROB_K1_PER_FORWARD} K1 "
          f"f32 launches and 0 K2; under set_fused_image_mode('on') "
          f"{ROB_K1_PER_FORWARD} K2 f32 launches and 0 K1, levels within "
          f"{err:.3g} of the K1 path (max |diff| / max |level|, bar "
          f"{F32_TOL})", flush=True)

    # where the Swin encoder's float32 forward spends its device time
    profile_train(lambda forwards: [rob_eval.collect_levels(
        swin_enc["module"], x, ROB_PROBES) for _ in range(forwards)], 5,
        forward_ms[swin_enc["name"]], tag="robustness swin",
        groups_of=_SWIN_GROUPS, unit="forward")

    attention = _attention_f32_per_forward()
    bound = attention["bound_ms"]
    print(f"[robustness] attention f32 per Swin encoder forward "
          f"({ROB_K1_PER_FORWARD} calls, {ROB_PROBES} probes), L2-cold: K1 "
          f"{attention['k1_ms']:.4f} ms ({100 * bound / attention['k1_ms']:.1f}"
          f" % of the bound; warm {attention['k1_warm_ms']:.4f}), plain "
          f"{attention['k1_plain_ms']:.4f}, SDPA f32 "
          f"{attention['k1_sdpa_ms']:.4f}; K2 {attention['k2_ms']:.4f} ms "
          f"({100 * bound / attention['k2_ms']:.1f} % of the bound; warm "
          f"{attention['k2_warm_ms']:.4f}), plain "
          f"{attention['k2_plain_ms']:.4f}, permute+SDPA f32+permute "
          f"{attention['k2_sdpa_ms']:.4f}; bound {bound:.4f} ms "
          f"({attention['bound_by']}: bytes {attention['bytes_ms']:.4f}, "
          f"operations at 67 TFLOP/s {attention['ops_ms']:.4f}); |kernel - "
          f"plain| K1 max {attention['k1_err']:.3g} mean "
          f"{attention['k1_mean_err']:.3g}, K2 max {attention['k2_err']:.3g}"
          f" mean {attention['k2_mean_err']:.3g} (bars {F32_TOL}, "
          f"{MEAN_TOL['torch.float32']})", flush=True)

    axes = dict(metrics=ROB_METRICS, margins=ROB_MARGINS, levels=ROB_LEVELS,
                pooled=(False, True), batch_size=ROB_PROBES)
    result = {}

    def run():
        result["rows"] = sweep.run_sweep(encoders, datasets, **axes)

    wa.window_attention_cuda.launches = 0
    wa.image_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the host syncs the sweep queues, where torch's sync debug mode
    # reports them (one warning each)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    launches = wa.window_attention_cuda.launches
    random_rows = result["rows"]
    check(len(random_rows) == ROB_ROWS
          and all(math.isfinite(r["robustness"]) for r in random_rows)
          and launches == 2 * ROB_K1_PER_FORWARD
          and wa.image_attention_cuda.launches == 0,
          f"[robustness] in-process sweep: {len(random_rows)} rows, K1 "
          f"{launches}, K2 {wa.image_attention_cuda.launches} launches")
    print(f"[robustness] in-process sweep (random init, {len(encoders)} "
          f"encoders x 2 views): {len(random_rows)} rows in {wall:.3f} s, "
          f"{len(syncs)} host syncs (sync debug mode, at {syncs}), K1 "
          f"launches {launches}", flush=True)

    # the same sweep with the Swin blocks on the image-layout path (K2)
    wa.window_attention_cuda.launches = 0
    wa.image_attention_cuda.launches = 0
    ops.set_fused_image_mode("on")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the Swin encoder's levels
            fused_rows = sweep.run_sweep(encoders, datasets, **axes)
    finally:
        ops.set_fused_image_mode("off")
    k2_launches = wa.image_attention_cuda.launches
    diff = max(abs(a["robustness"] - b["robustness"])
               for a, b in zip(fused_rows, random_rows))
    check(len(fused_rows) == ROB_ROWS and diff < ROB_ROW_TOL
          and k2_launches == 2 * ROB_K1_PER_FORWARD
          and wa.window_attention_cuda.launches == 0,
          f"[robustness] in-process sweep under set_fused_image_mode('on'):"
          f" {len(fused_rows)} rows, max |K2 path - K1 path| {diff}, K2 "
          f"{k2_launches}, K1 {wa.window_attention_cuda.launches} launches")
    print(f"[robustness] in-process sweep under set_fused_image_mode('on'): "
          f"{len(fused_rows)} rows, max |K2 path - K1 path| {diff:.3g} (bar "
          f"{ROB_ROW_TOL}), K2 launches {k2_launches}, K1 0", flush=True)

    # the CLI as a user runs it, with three weight sources
    gen_cfg = ConfigDict({"encoders": robustness_encoders(ROB_SIZE)})
    weights = {"u-net_encoder": str(encoder)}
    for enc, family in zip(build_encoders(gen_cfg, datasets, 9,
                                          torch.device("cpu"))[1:],
                           ("resnet", "swin")):
        path = workdir / f"{enc['name']}_reference.pt"
        save_params_file(str(path), reference_names(
            enc["module"].state_dict(), family))
        weights[enc["name"]] = str(path)
    encoders_cfg = robustness_encoders(ROB_SIZE)
    for enc in encoders_cfg:
        enc["weights"] = weights[enc["name"]]
    out_csv = workdir / "robustness_scores.csv"
    cfg_path = workdir / "robustness.yaml"
    cfg_path.write_text(dump_yaml(robustness_config(out_csv, encoders_cfg)))
    env = dict(os.environ, MST_DATA_DIR=str(workdir / "rob_data"),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.robustness",
         str(cfg_path)], cwd=workdir, env=env, capture_output=True,
        text=True, timeout=400)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f"[robustness] CLI exit {out.returncode}; "
                               f"stderr tail:\n{out.stderr[-4000:]}")
    said = [w for w in ("unmapped", "left random", "unused")
            if w in out.stdout]
    check(not said, f"[robustness] CLI load warnings {said}:\n"
                    f"{out.stdout[-3000:]}")
    import csv
    with open(out_csv, newline="") as fh:
        reader = csv.DictReader(fh)
        header, rows = reader.fieldnames, list(reader)
    check(header == ROB_CSV_COLUMNS and len(rows) == ROB_ROWS,
          f"[robustness] CSV header {header}, {len(rows)} rows "
          f"(want {ROB_ROWS})")
    values = [float(r["robustness"]) for r in rows]
    check(all(math.isfinite(v) for v in values),
          "[robustness] CSV values not all finite")
    levels, cells = {}, {}
    for r in rows:
        levels.setdefault(r["encoder"], set()).add(int(r["level"]))
        cells.setdefault((r["metric"], r["encoder"], r["level"],
                          r["pooled"]), []).append(
            (float(r["margin"]), float(r["robustness"])))
    check({k: sorted(v) for k, v in levels.items()} == ROB_ENCODER_LEVELS,
          f"[robustness] levels per encoder {levels}")
    monotone = sum(all(b[1] >= a[1] for a, b in zip(s, s[1:]))
                   for s in (sorted(c) for c in cells.values()))
    check(monotone == len(cells),
          f"[robustness] {monotone} of {len(cells)} cells non-decreasing "
          f"in margin")
    differs = {name: sum(abs(float(r["robustness"]) - q["robustness"])
                         > 1e-6 for r, q in zip(rows, random_rows)
                         if r["encoder"] == name)
               for name in ROB_ENCODER_LEVELS}
    check(all(differs.values()),
          f"[robustness] rows differing from the random-init sweep: "
          f"{differs}")
    print(f"[robustness] CLI robustness_224: {len(rows)} rows in "
          f"{seconds:.1f} s of wall time (process included), header equal "
          f"to the JAX CLI's, all finite, {monotone}/{len(cells)} cells "
          f"non-decreasing in margin, levels "
          f"{ {k: sorted(v) for k, v in levels.items()} }; weights loaded "
          f"with no unmapped, unused or missing key (u-net_encoder from "
          f"{encoder.name}, resnet50 and swin_transformer from "
          f"reference-named state dicts); rows differing from the "
          f"random-init sweep per encoder {differs}; values "
          f"[{min(values):.4g}, {max(values):.4g}]", flush=True)
    return {"k1": launches, "k2": k2_launches, "attention": attention}


# ---------------------------------------------------------------------------
# training the Swin U-Net and the ResNet-50 attention U-Net
# ---------------------------------------------------------------------------

#: swin_224_train (bench.py:419-509): batch and side
SWIN_TRAIN_BATCH, SWIN_TRAIN_SIZE = 24, 224
#: resnet50_attention_unet_256_train: batch, side (the COVID-QU size of
#: unet_256_train) and the decoder widths: the reference's yaml is not in
#: the repo, so five entries, one up more than ResNet-50's four levels
#: (it undoes the stem's /2), halving to 64 and 32 at the top
RESNET_TRAIN_BATCH, RESNET_TRAIN_SIZE = 16, 256
RESNET_DECODER = (1024, 512, 256, 64, 32)
#: blocks of swin_unet_224, each one K1 (or K2) launch per forward
SWIN_BLOCKS = 14
#: the attention routes of a Swin training step: (the dispatch's force,
#: fused image mode); "k1" and "plain" are the two candidates for
#: train=True, "k1" the dispatch's own
TRAIN_ROUTES = {"k1": (None, "off"), "plain": ("torch", "off"),
                "k2": (None, "on")}
#: [swin train small]: the small f32 Swin U-Net (tests/test_torch_swin_train
#: .py) stepped on the card against the CPU, TF32 off, 3 steps of 2
#: fragments of 2
SWIN_SMALL_STEPS = 3
#: [cli swin], [cli resnet]: training and test images, side, batch, and
#: the SGD lr (momentum 0.9).  From its random init the Swin U-Net at
#: 0.01 stayed at the all-background start (val Dice 0) for 3 epochs of 8
#: and of 32 steps on an H100; at 0.05, 32 steps an epoch.  Not
#: swin_224_train's 1e-3: the CLI cells check that the family learns
FAMILY_CLI = {"swin": (768, 48, SWIN_TRAIN_SIZE, SWIN_TRAIN_BATCH, 0.05),
              "resnet": (256, 16, RESNET_TRAIN_SIZE, RESNET_TRAIN_BATCH,
                         0.01)}
#: the CLI family runs learn: the 3rd epoch's train Dice loss is below the
#: 1st's over this factor (the Swin U-Net stuck at lr 0.01 on an H100 read
#: 0.416 -> 0.374, 1.1 times; learning at 0.05, 0.345 -> 0.0145)
CLI_LOSS_FACTOR = 4.0
#: kernel-name fragments -> the group of the Swin U-Net's train step, for
#: [profile swin train]; the first match wins
_SWIN_TRAIN_GROUPS = (
    ("attention_bwd", "attention backward kernels (K1, K2)"),
    ("sum_partials", "attention backward kernels (K1, K2)"),
    ("softmax", "softmax (plain attention)"),
    ("bmm", "attention products (plain attention)"),
    ("multi_tensor_apply", "optimizer, grad mean and norm (foreach)"),
    *_SWIN_GROUPS)


def _segmentation_training(lr: float) -> dict:
    """swin224_train's training: SGD momentum 0.9 at a constant *lr*, the
    Dice loss (squared-prediction denominator), Dice at 0.5 logged."""
    return {
        "training": {
            "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                "constant": {"base": lr}}}},
            "loss": {"segmentation.losses.DiceLoss": {}}},
        "metrics": {"metrics": ("metrics.DiceIndex",)},
    }


def swin_224_train_config(small: bool = False, rate: float = 0.2) -> dict:
    """``swin_224_train``: swin_unet_224 (stochastic depth *rate*) with the
    reference yaml's trunc-normal init and swin224_train's training.
    *small*: tests/test_torch_swin_train.py's model (32 x 32, embed 8,
    heads (2, 4), window 4, depth 1, width 2)."""
    cfg = swin_unet_224_config()
    unet = cfg["model"]["segmentation.models.UNet"]
    arch = unet["architecture"]
    arch["stochastic depth rate"] = rate
    if small:
        arch.update(channels=(8, 16), depth=1)
        arch["basic_block"]["segmentation.models.blocks.SwinTransformerBlock"] \
            .update(img_size=32, embed_dim=8, num_heads_layers=(2, 4),
                    window_size=4)
    unet["weight_init"] = {"random": {
        "timm.models.layers.trunc_normal_": {"std": 0.02}}}
    return {**cfg, **_segmentation_training(1e-3)}


def resnet_attention_unet_config() -> dict:
    """``resnet50_attention_unet_256_train``: the U-Net with ResNet-50 v1
    (bottleneck blocks 3-4-6-3, 256 -> 2048, base 64, 3 input channels) as
    its external encoder, AttentionBlock mixing and RESNET_DECODER, kaiming
    init, swin224_train's training."""
    return {"model": {"segmentation.models.UNet": {
        "architecture": {
            "activation function": {"final": "sigmoid"},
            "encoder": {"classification.models.DeepResNet": {
                "version": "v1", "bottleneck": True,
                "channel_sizes": (256, 512, 1024, 2048),
                "widths": (3, 4, 6, 3), "in_channels": 3,
                "base_channel_size": 64}},
            "mixing_block": {"segmentation.models.blocks.AttentionBlock": {}},
            "out_channel_size": 1, "decoder_channels": RESNET_DECODER},
        "weight_init": {"random": {"torch.nn.init.kaiming_normal_": {
            "nonlinearity": "relu"}}}}},
        **_segmentation_training(1e-3)}


@contextlib.contextmanager
def attention_route(route: str):
    """Pin the Swin blocks' attention to *route* of TRAIN_ROUTES (the plain
    version through the dispatch's ``force``), then restore the
    defaults."""
    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.models import swin

    force, mode = TRAIN_ROUTES[route]
    core = swin.window_attention_core
    if force is not None:
        swin.window_attention_core = functools.partial(core, force=force)
    ops.set_fused_image_mode(mode)
    try:
        yield
    finally:
        swin.window_attention_core = core
        ops.set_fused_image_mode("off")


@contextlib.contextmanager
def tf32_off():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def phase_swin_train_small():
    """The small f32 Swin U-Net at stochastic depth 0 (card and CPU draw
    differently), SWIN_SMALL_STEPS steps of two fragments of 2 on the card
    (K1 under autograd: its forward and its backward kernel) and on the
    CPU (plain autograd) from the same weights, TF32 off: losses,
    parameters within TRAIN_TOL, the K1 launches, forward and backward,
    inside the steps; then the same under set_fused_image_mode("on") with
    K2."""
    import torch

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    cfg = swin_224_train_config(small=True, rate=0.0)
    for route, kernel in (("k1", wa.window_attention_cuda),
                          ("k2", wa.image_attention_cuda)):
        runs = []
        for device in ("cpu", "cuda"):
            model, state, calculator, step = build_trainer(cfg, device)
            metrics_state = calculator.init_state(device)
            losses = []
            counted = (wa.window_attention_cuda, wa.image_attention_cuda,
                       wa.window_attention_backward_cuda,
                       wa.image_attention_backward_cuda)
            for counter in counted:
                counter.launches = 0
            with tf32_off(), attention_route(route):
                for k in range(SWIN_SMALL_STEPS):
                    batch = {key: v.to(device) for key, v in
                             segmentation_batch(2, 2, 32, seed=k).items()}
                    state, metrics_state, per_batch = step(
                        state, metrics_state, batch)
                    losses.append(per_batch["dice_loss"].item())
            launches = tuple(counter.launches for counter in counted)
            runs.append((losses, {k: v.double().cpu() for k, v in
                                  model.module.state_dict().items()}))
        (cpu_losses, cpu_state), (losses, state) = runs
        loss_err = max(abs(a - b) for a, b in zip(losses, cpu_losses))
        state_err = {k: (v - cpu_state[k]).abs().max().item()
                     for k, v in state.items()}
        worst = max(state_err, key=state_err.get)
        # 6 blocks, one launch per forward of each and one of its
        # backward, 2 fragments per step
        want = 6 * 2 * SWIN_SMALL_STEPS
        expected = (want, 0, want, 0) if route == "k1" else (0, want, 0, want)
        check(loss_err < TRAIN_TOL and state_err[worst] < TRAIN_TOL
              and launches == expected,
              f"[swin train small] {route}: card vs CPU loss {loss_err}, "
              f"{worst} {state_err[worst]} (bar {TRAIN_TOL}); launches "
              f"K1, K2 and their backward kernels {launches} (want "
              f"{expected})")
        print(f"[swin train small] f32 Swin U-Net 32x32, {SWIN_SMALL_STEPS} "
              f"steps of 2 fragments of 2, TF32 off, {route} "
              f"({kernel.__name__} forward under autograd, its backward "
              f"kernel): card vs CPU max |diff| loss {loss_err:.3g}, "
              f"parameters {state_err[worst]:.3g} ({worst}; bar "
              f"{TRAIN_TOL}); launches K1, K2, K1 backward, K2 backward "
              f"{launches}", flush=True)


def _train_turns(run_steps, routes) -> dict:
    """TURNS turns of TURN_STEPS steps per route, the routes in turns
    (k1, plain, k2, k2, plain, k1, ...), each turn under sync debug mode
    "error" and with the launch counts set to 0 just before it.  Returns
    per route: seconds of each turn, K1 and K2 launches and their backward
    kernels' (k1_bwd, k2_bwd), peak memory."""
    import torch

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    kernels = {"k1": wa.window_attention_cuda, "k2": wa.image_attention_cuda,
               "k1_bwd": wa.window_attention_backward_cuda,
               "k2_bwd": wa.image_attention_backward_cuda}
    out = {r: {"turns": [], "peak": 0, **{k: 0 for k in kernels}}
           for r in routes}
    for i in range(TURNS):
        for route in (routes if i % 2 == 0 else routes[::-1]):
            with attention_route(route):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for kernel in kernels.values():
                    kernel.launches = 0
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    run_steps(TURN_STEPS)
                except RuntimeError as exc:
                    fail(f"a host sync in a train step ({route}): {exc}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            res = out[route]
            res["turns"].append(seconds)
            for name, kernel in kernels.items():
                res[name] += kernel.launches
            res["peak"] = max(res["peak"], torch.cuda.max_memory_allocated())
    return out


def train_cell(tag: str, cfg: dict, batch_size: int, size: int,
               n_params: int, routes=("k1",), after=None) -> dict:
    """Build the trainer of *cfg* in bf16 on the card, warm it up on each
    route, time the routes in turns (:func:`_train_turns`) on one fixed
    batch, check the losses finite and falling, and print images/s, ms per
    step, the share of the operations bound, launches per step and peak
    memory per route; then profile the first route and call
    ``after(run_steps)`` if given.  Returns the per-route results with
    ``images_per_s`` and ``step_ms``, the first route's with its
    ``profile``."""
    import torch

    from medsegpretrainimagenet_tpu_torch.models import blocks

    torch.backends.cudnn.benchmark = True
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        model, state, calculator, step = build_trainer(cfg, "cuda")
        got = sum(p.numel() for p in model.module.parameters())
        check(got == n_params, f"{tag}: {got} parameters, want {n_params}")
        batch = {k: v.cuda() for k, v in segmentation_batch(
            1, batch_size, size, seed=0).items()}
        x0 = batch["x"][0, :1].float() / 255.0
        macs, first_macs = conv_macs(model.module, x0)
        flops = 2 * batch_size * (3 * macs - first_macs)
        bound_ms = 1e3 * flops / PEAK_OPS_PER_S["torch.bfloat16"]
        print(f"[{tag}] {n_params} parameters, forward "
              f"{macs / 1e9:.2f} GMAC per image, train step "
              f"{flops / 1e12:.3f} TFLOP at batch {batch_size} ({size}x"
              f"{size}): bound {bound_ms:.3f} ms (operations, bf16 at 989 "
              f"TFLOP/s)", flush=True)
        metrics_state = calculator.init_state("cuda")
        losses = []

        def run_steps(n):
            nonlocal state, metrics_state
            for _ in range(n):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       batch)
                losses.append(per_batch["dice_loss"])

        t0 = time.perf_counter()
        for route in routes:
            with attention_route(route):
                run_steps(3)  # cuDNN autotuning, the route's own kernels
        torch.cuda.synchronize()
        print(f"[{tag}] warm-up, 3 steps per route: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        results = _train_turns(run_steps, list(routes))
        loss = torch.stack(losses).float().cpu()
        check(bool(torch.isfinite(loss).all())
              and loss[-TURN_STEPS:].mean() < loss[:TURN_STEPS].mean(),
              f"[{tag}] losses finite and falling: first "
              f"{loss[:TURN_STEPS].tolist()}, last "
              f"{loss[-TURN_STEPS:].tolist()}")
        print(f"[{tag}] {len(loss)} steps on one batch, no host sync "
              f"queued (sync debug mode 'error'): dice loss, mean of the "
              f"first {TURN_STEPS} {loss[:TURN_STEPS].mean():.4f}, of the "
              f"last {TURN_STEPS} {loss[-TURN_STEPS:].mean():.4f}",
              flush=True)
        steps = TURNS * TURN_STEPS
        for route, res in results.items():
            step_ms = [1e3 * t / TURN_STEPS for t in res["turns"]]
            res["step_ms"] = statistics.median(step_ms)
            res["images_per_s"] = statistics.median(
                batch_size * TURN_STEPS / t for t in res["turns"])
            res["spread_ms"] = max(step_ms) - min(step_ms)
            res["bound_ms"] = bound_ms
            print(f"[{tag}] {route}: images/s median "
                  f"{res['images_per_s']:.1f} of "
                  f"{sorted(round(batch_size * TURN_STEPS / t, 1) for t in res['turns'])}"
                  f"; {res['step_ms']:.3f} ms per step (turns "
                  f"{min(step_ms):.3f} to {max(step_ms):.3f}), "
                  f"{100 * bound_ms / res['step_ms']:.1f} % of the "
                  f"{bound_ms:.3f} ms bound; launches per step K1 "
                  f"{res['k1'] / steps:g} (backward {res['k1_bwd'] / steps:g})"
                  f", K2 {res['k2'] / steps:g} (backward "
                  f"{res['k2_bwd'] / steps:g}); peak memory "
                  f"{res['peak'] / 2 ** 30:.2f} GiB", flush=True)
        main = routes[0]
        with attention_route(main):
            results[main]["profile"] = profile_train(
                run_steps, 3, results[main]["step_ms"], tag=tag,
                groups_of=_SWIN_TRAIN_GROUPS if "swin" in tag else None)
        if after is not None:
            after(run_steps)
        return results
    finally:
        blocks.set_compute_dtype(None)


def _step_device_ms(fn, iters: int = 5) -> float:
    """Device ms per call of *fn* (one step's 14 attention pairs, a few
    hundred launches): *iters* calls queued behind a spin kernel that
    holds the stream for twice the host's time to queue them, so that the
    events time the device and not Python; the median of 3 runs."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        # about 2e9 spin cycles a second
        torch.cuda._sleep(int(2 * iters * host_s * 2e9))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _rel_err(got, want) -> float:
    """The worst max |got - want| of a list of tensors, each relative to
    the largest |want|."""
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
               for a, b in zip(got, want))


def _train_pair_result(pairs: dict, moved: int, ops: int, fwd_err: float,
                       bwd_err: float) -> dict:
    """Time the forward + backward *pairs* ({"ms": the kernel pair,
    "recompute_ms", "plain_ms", "sdpa_ms"}: callables) with
    :func:`_step_device_ms` and add the bound of *moved* bytes and *ops*
    bf16 operations."""
    import torch

    out = {"fwd_err": fwd_err, "bwd_err": bwd_err,
           "bytes_ms": 1e3 * moved / HBM_BYTES_PER_S,
           "ops_ms": 1e3 * ops / PEAK_OPS_PER_S["torch.bfloat16"]}
    for key, fn in pairs.items():
        if key in ("ms", "recompute_ms"):
            with torch.no_grad():
                out[key] = _step_device_ms(fn)
        else:
            out[key] = _step_device_ms(fn)
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] \
        else "operations"
    return out


def _attention_train_pair() -> dict:
    """The attention of one swin_224_train step (the 14 calls of LEVELS at
    batch 24, bf16) forward and backward, four ways on the same tensors:
    K1's forward with its backward kernel (the kernel pair), K1's forward
    with the plain float32 recompute backward (the pair before the
    backward kernel, kept as a yardstick), the plain version under
    autograd, and SDPA under autograd with bias and mask as one additive
    mask (the library yardstick).  Device ms per step (CUDA events with
    the stream held while the calls are queued), K1's outputs and the
    backward kernel's gradients against plain autograd, and the bound."""
    import torch
    import torch.nn.functional as F

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(7)
    scale = HEAD_DIM ** -0.5
    calls, moved, ops = [], 0, 0
    for level, heads, n_w, masked, unmasked in LEVELS:
        for is_masked in [True] * masked + [False] * unmasked:
            q, k, v, bias, mask = _k1_inputs(level, heads, n_w, is_masked,
                                             torch.bfloat16, gen)
            g = torch.randn(q.shape, generator=gen).to("cuda", q.dtype)
            for t in (q, k, v, bias):
                t.requires_grad_(True)
            calls.append((q, k, v, bias, mask, g))
            b_, h, n, d = q.shape
            # read q, k, v, g, bias, mask; write out, dq, dk, dv, dbias
            moved += 8 * q.numel() * 2 + 2 * bias.numel() * 4 \
                + (0 if mask is None else mask.numel() * 4)
            # forward 2 products, backward 4 (dv, dP, dq, dk)
            ops += 12 * b_ * h * n * n * d

    def kernel_pair():
        """per call: K1's output, then dq, dk, dv, dbias"""
        return [(wa.window_attention_cuda(q, k, v, b, m, scale),
                 *wa.window_attention_backward_cuda(
                     q, k, v, b, m, scale, g, mask_grad=False)[:4])
                for q, k, v, b, m, g in calls]

    def recompute_pair():
        return [(wa.window_attention_cuda(q, k, v, b, m, scale),
                 *wa.window_attention_backward(q, k, v, b, m, scale, g)[:4])
                for q, k, v, b, m, g in calls]

    def plain_pair():
        return [torch.autograd.grad(
            wa.window_attention_torch(q, k, v, b, m, scale), (q, k, v, b), g)
            for q, k, v, b, m, g in calls]

    def sdpa_pair():
        return [torch.autograd.grad(F.scaled_dot_product_attention(
            q, k, v, attn_mask=_sdpa_mask(b, m, q.shape[0], q.dtype),
            scale=scale), (q, k, v, b), g) for q, k, v, b, m, g in calls]

    with torch.no_grad():
        got = kernel_pair()
        outs = [wa.window_attention_torch(q, k, v, b, m, scale)
                for q, k, v, b, m, _ in calls]
    want = plain_pair()
    fwd_err = _rel_err([pair[0] for pair in got], outs)
    bwd_err = max(_rel_err(pair_got[1:], pair_want)
                  for pair_got, pair_want in zip(got, want))
    check(fwd_err < BF16_TOL and bwd_err < BF16_TOL,
          f"[swin train] the kernel pair against plain autograd, relative "
          f"max |diff|: K1's outputs {fwd_err}, the backward kernel's "
          f"gradients {bwd_err} (bar {BF16_TOL})")
    return _train_pair_result(
        {"ms": kernel_pair, "recompute_ms": recompute_pair,
         "plain_ms": plain_pair, "sdpa_ms": sdpa_pair},
        moved, ops, fwd_err, bwd_err)


def _image_train_pair() -> dict:
    """The same for the image layout: the 14 calls of one swin_224_train
    step under set_fused_image_mode("on") (qkv (24, R, R, 3C) of each
    level, bf16), forward and backward: K2's forward with its backward
    kernel, K2's forward with the plain recompute backward, the plain
    version under autograd, and the library yardstick: the layout permute,
    SDPA and the permute back under autograd."""
    import torch

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    gen = torch.Generator().manual_seed(8)
    scale = HEAD_DIM ** -0.5
    calls, moved, ops = [], 0, 0
    for level, heads, n_w, masked, unmasked in LEVELS:
        res = 56 // 2 ** level
        for is_masked in [True] * masked + [False] * unmasked:
            c = heads * HEAD_DIM
            qkv = torch.randn(BATCH, res, res, 3 * c,
                              generator=gen).to("cuda", torch.bfloat16)
            g = torch.randn(BATCH, res, res, c,
                            generator=gen).to("cuda", torch.bfloat16)
            bias, mask = _tables(level, heads, is_masked, gen)
            for t in (qkv, bias):
                t.requires_grad_(True)
            calls.append((qkv, bias, mask, g))
            # read qkv, g, bias, mask; write out, dqkv, dbias
            moved += (qkv.numel() * 8 // 3) * 2 + 2 * bias.numel() * 4 \
                + (0 if mask is None else mask.numel() * 4)
            ops += 12 * BATCH * n_w * heads * TOKENS * TOKENS * HEAD_DIM

    def kernel_pair():
        return [(wa.image_attention_cuda(x, b, m, scale, WINDOW),
                 *wa.image_attention_backward_cuda(
                     x, b, m, scale, WINDOW, g, mask_grad=False)[:2])
                for x, b, m, g in calls]

    def recompute_pair():
        return [(wa.image_attention_cuda(x, b, m, scale, WINDOW),
                 *wa.image_attention_backward(x, b, m, scale, WINDOW,
                                              g)[:2])
                for x, b, m, g in calls]

    def plain_pair():
        return [torch.autograd.grad(
            wa.image_attention_torch(x, b, m, scale, WINDOW), (x, b), g)
            for x, b, m, g in calls]

    def sdpa_pair():
        return [torch.autograd.grad(_sdpa_image_path(
            x, _sdpa_mask(b, m, x.shape[0] * (x.shape[1] // WINDOW) ** 2,
                          x.dtype), scale), (x, b), g)
            for x, b, m, g in calls]

    with torch.no_grad():
        got = kernel_pair()
        outs = [wa.image_attention_torch(x, b, m, scale, WINDOW)
                for x, b, m, _ in calls]
    want = plain_pair()
    fwd_err = _rel_err([pair[0] for pair in got], outs)
    bwd_err = max(_rel_err(pair_got[1:], pair_want)
                  for pair_got, pair_want in zip(got, want))
    check(fwd_err < BF16_TOL and bwd_err < BF16_TOL,
          f"[swin train] the K2 pair against plain autograd, relative max "
          f"|diff|: K2's outputs {fwd_err}, the backward kernel's gradients "
          f"{bwd_err} (bar {BF16_TOL})")
    return _train_pair_result(
        {"ms": kernel_pair, "recompute_ms": recompute_pair,
         "plain_ms": plain_pair, "sdpa_ms": sdpa_pair},
        moved, ops, fwd_err, bwd_err)


def phase_swin_train() -> dict:
    """swin_224_train at full width (27,166,596 parameters, 224 x 224,
    batch 24, bf16, stochastic depth 0.2, SGD momentum 0.9 at 1e-3, Dice
    loss), timed in turns on the two candidates for train=True (K1 with its
    backward kernel, the dispatch's own; the plain version under autograd)
    and on the image-layout path (K2 with its backward kernel), 14 launches
    of the route's forward and backward kernels per step and none of the
    others'; the attention pair of one step, on each layout, against the
    pair with the plain recompute backward, plain autograd and SDPA; the
    verdict for train=True."""
    results = train_cell("swin train", swin_224_train_config(),
                         SWIN_TRAIN_BATCH, SWIN_TRAIN_SIZE, 27_166_596,
                         routes=("k1", "plain", "k2"))
    steps = TURNS * TURN_STEPS
    want = {"k1": ("k1", "k1_bwd"), "k2": ("k2", "k2_bwd"), "plain": ()}
    for route, kernels in want.items():
        for name in ("k1", "k1_bwd", "k2", "k2_bwd"):
            expected = SWIN_BLOCKS * steps if name in kernels else 0
            check(results[route][name] == expected,
                  f"[swin train] {route} route: {results[route][name]} "
                  f"launches of {name} in {steps} steps, want {expected}")
    pairs = {"k1": _attention_train_pair(), "k2": _image_train_pair()}
    for path, pair in pairs.items():
        kernel = path.upper()
        print(f"[swin train] attention of one step on {kernel} (14 calls, "
              f"bf16, forward + backward): {kernel} + its backward kernel "
              f"{pair['ms']:.3f} ms ({100 * pair['bound_ms'] / pair['ms']:.1f}"
              f" % of the bound), {kernel} + the plain recompute backward "
              f"{pair['recompute_ms']:.3f} ms, plain autograd "
              f"{pair['plain_ms']:.3f} ms, "
              f"{'SDPA' if path == 'k1' else 'permute + SDPA + permute'} "
              f"with one additive mask {pair['sdpa_ms']:.3f} ms; bound "
              f"{pair['bound_ms']:.3f} ms ({pair['bound_by']}: bytes "
              f"{pair['bytes_ms']:.3f}, operations {pair['ops_ms']:.3f}); "
              f"against plain autograd, relative max |diff|: {kernel}'s "
              f"outputs {pair['fwd_err']:.3g}, the backward kernel's "
              f"gradients {pair['bwd_err']:.3g} (bar {BF16_TOL})",
              flush=True)
    k1, plain = results["k1"], results["plain"]
    gap = plain["step_ms"] - k1["step_ms"]
    spread = max(k1["spread_ms"], plain["spread_ms"])
    faster = "k1" if gap > spread else "plain" if -gap > spread else "tie"
    print(f"[swin train] train=True: the step with K1 {k1['step_ms']:.3f} "
          f"ms, plain {plain['step_ms']:.3f} ms (plain - K1 {gap:.3f} ms, "
          f"the turns' spread {spread:.3f} ms): faster beyond the spread: "
          f"{faster}; train=True takes K1 and its backward kernel (the "
          f"dispatch has no other route for a CUDA tensor)", flush=True)
    return {"launches": results["k1"]["k1"], "k1_cell": results["k1"],
            "bwd_launches": results["k1"]["k1_bwd"],
            "k2_launches": results["k2"]["k2"],
            "k2_bwd_launches": results["k2"]["k2_bwd"], "pair": pairs["k1"],
            "k2_pair": pairs["k2"]}


def phase_resnet_train() -> None:
    """resnet50_attention_unet_256_train at full width (94,014,977
    parameters), timed as [swin train] times its step (no attention kernel
    lies on it)."""
    results = train_cell("resnet train", resnet_attention_unet_config(),
                         RESNET_TRAIN_BATCH, RESNET_TRAIN_SIZE, 94_014_977)
    check(all(results["k1"][k] == 0
              for k in ("k1", "k2", "k1_bwd", "k2_bwd")),
          f"[resnet train] an attention kernel launched: {results}")


def family_cli_config(workdir: Path, family: str, epochs: int,
                      weights: Path) -> dict:
    """The experiment CLI's config of *family* ("swin": swin_224_train's
    model at stochastic depth 0.2; "resnet": the ResNet-50 attention U-Net)
    on a COVID-QU tree of FAMILY_CLI's size, bf16, its encoder from the
    reference-named state dict *weights*; no cuDNN autotuning (a large
    part of each process's first epoch)."""
    images, test, size, batch, lr = FAMILY_CLI[family]
    cfg = swin_224_train_config() if family == "swin" \
        else resnet_attention_unet_config()
    model = cfg["model"]["segmentation.models.UNet"]
    model["weight_init"]["encoder"] = {"weights": str(weights),
                                       "strict": True}
    technical = {"seed": 777, "save_destination": str(workdir / "logs"),
                 "maximum_actual_batch_size": batch,
                 "mixed_precision": True, "async_checkpointing": True,
                 "use_cudnn_benchmarking": False,
                 "export_plots_as": ("json",),
                 "model_evaluation": {
                     "metric": "val_metrics/dice_index_threshold_0.5",
                     "mode": "max"}}
    return {
        "experiment": {"number_of_epochs": epochs, "number_of_trials": 1},
        "meta": {"technical": technical},
        "data": {"data": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": size,
            "validate_on_test": True, "seed": 20231027}},
            "sampling": {"batch_size": batch},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": cfg["model"],
        "training": {"loss": {"segmentation.losses.DiceLoss": {}},
                     "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                         "constant": {"base": lr}}}}},
        "metrics": {"metrics": ("metrics.DiceIndex",)},
    }


def phase_cli_family(workdir: Path, family: str) -> int:
    """[cli swin] / [cli resnet]: the experiment CLI in a process of its
    own on a synthetic COVID-QU tree, three epochs in one process (the
    resume under --continued is [cli]'s, [cli acdc]'s and the CPU tests'
    of both families: a process of its own took 25 s each of the script's
    time), the encoder grafted from a reference-named state dict
    written here (an encoder of the config's own random init); the run
    files, the logs, the val Dice rising, the train Dice loss falling
    CLI_LOSS_FACTOR times over the three epochs.  For the
    Swin U-Net, the K1 launches of a no-grad validation pass of the
    trained model in this process.  Returns those launches."""
    import numpy as np
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.losses import Loss
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.models import blocks
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt
    from medsegpretrainimagenet_tpu_torch.train import make_eval_step

    tag = f"cli {family}"
    t0 = time.perf_counter()
    images, test, size, batch, _ = FAMILY_CLI[family]
    workdir.mkdir()
    write_covidqu_tree(workdir / "data", images=images, size=size, test=test)
    cfg = family_cli_config(workdir, family, 2, workdir / "encoder.pt")
    cd = ConfigDict(cfg)
    cd.expand()
    model = build_trainer(swin_224_train_config() if family == "swin"
                          else resnet_attention_unet_config(), "cpu",
                          seed=5)[0]
    encoder = {k[len("enc."):]: v for k, v in
               model.module.state_dict().items() if k.startswith("enc.")}
    ckpt.save_params_file(str(workdir / "encoder.pt"), reference_names(
        encoder, family))
    wall, out = _cli_process(workdir, family_cli_config(
        workdir, family, 3, workdir / "encoder.pt"))
    marks = [m for m in ENVELOPE_MARKS + ("Unmapped", "Missing keys",
                                          "Unexpected keys")
             if m in out.stderr]
    check(out.returncode == 0 and not marks
          and "Successfully initialised encoder from" in out.stdout,
          f"[{tag}] {' '.join(out.args[3:])}: exit {out.returncode}, "
          f"marks {marks}; stdout tail:\n{out.stdout[-2000:]}\nstderr "
          f"tail:\n{out.stderr[-4000:]}")
    (run,) = (workdir / "logs").glob("*/Experiment/run_1")
    rows = _csv_rows(run / "epoch_logs.csv")
    steps = images // batch
    check(len(rows) == 3 and set(rows[0]) == CLI_EPOCH_COLUMNS
          and len(_csv_rows(run / "batch_logs.csv")) == 3 * steps
          and all(math.isfinite(float(v)) for r in rows for v in r.values()),
          f"[{tag}] logs: {len(rows)} epoch rows, columns "
          f"{sorted(rows[0]) if rows else None}")
    for name in ("last_model_state_dict.pt", "best_model_state_dict.pt"):
        model.module.load_state_dict(ckpt.load_params_file(run / name))
    saved = ckpt.load_state_file(run / "optimizer_state_dict.pt")
    check(saved["step"] == 3 * steps and ckpt.load_params_file(
        run / "checkpoint_epoch.pt") == {"epoch": 3},
          f"[{tag}] optimizer step {saved['step']}, want {3 * steps}")
    dice = [float(r["val_metrics/dice_index_threshold_0.5"]) for r in rows]
    loss = [float(r["dice_loss"]) for r in rows]
    check(dice[-1] > dice[0] and loss[-1] * CLI_LOSS_FACTOR < loss[0],
          f"[{tag}] val Dice {dice} rising, train Dice loss {loss} falling "
          f"by more than {CLI_LOSS_FACTOR} times")

    launches = 0
    if family == "swin":
        # a no-grad validation pass of the trained model, bf16
        model.module.load_state_dict(ckpt.load_params_file(
            run / "last_model_state_dict.pt"))
        model.module.cuda()
        base = workdir / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
            / "COVID-19" / "test"
        imgs = np.load(base / "imgs.npy")[:batch, 0]
        masks = np.load(base / "inf_masks.npy")[:batch, 0] > 0
        stack = {"x": torch.from_numpy(np.repeat(imgs[..., None], 3, -1))
                 [None].cuda(),
                 "mask": torch.from_numpy(masks.astype(np.uint8))[None]
                 .cuda()}
        registry.fill_spec(cd, "training/loss")
        loss_fn = registry.build(cd, key="training/loss", wrapper=Loss)
        calculator = MetricsCalculator(cd, loss=loss_fn)
        blocks.set_compute_dtype(torch.bfloat16)
        try:
            wa.window_attention_cuda.launches = 0
            metrics_state, _ = make_eval_step(model, loss_fn, calculator)(
                None, calculator.init_state("cuda"), stack)
            torch.cuda.synchronize()
            launches = wa.window_attention_cuda.launches
        finally:
            blocks.set_compute_dtype(None)
        values = calculator.finalize_epoch(metrics_state)
        check(launches == SWIN_BLOCKS
              and all(math.isfinite(v) for v in values.values()),
              f"[{tag}] validation pass: {launches} K1 launches (want "
              f"{SWIN_BLOCKS}), {values}")
    print(f"[{tag}] {images} + {test} images of {size}x{size}, batch "
          f"{batch}: 3 epochs {wall:.1f} s; encoder grafted from a "
          f"reference-named "
          f"state dict with no unmapped, unused or missing key; val Dice "
          f"{[round(d, 4) for d in dice]}, train Dice loss "
          f"{[round(v, 4) for v in loss]}"
          + (f"; {launches} K1 launches in a no-grad validation pass of "
             f"{batch} images" if family == "swin" else ""), flush=True)
    print(f"[{tag}] {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# the residual block zoo, MixedDataset and IDRiD
# ---------------------------------------------------------------------------

#: [blocks small]: one small f32 U-Net per block kind of the residual zoo
#: (depth 2, channels 8-16-32, width 2), with its shortcut, layer scaling
#: 0.1 and stochastic depth 0.1, stepped card vs CPU as [train small] steps
#: the ConvBlock U-Net; the drop paths fed in alike to both (the card and
#: the CPU draw differently)
BLOCK_ZOO = (
    ("ResNeXtBlock", {"identity": {"expand_method": "fill_with_zeros"}}),
    ("InvertedBottleneckBlock", "convolution"),
    ("ConvNeXtBlock", {"down": "identity", "up": {"convolution": {
        "kernel_size": 3}}}))
#: [cli mixed]: a MixedDataset of two COVID-QU readers on a tree of the
#: [cli] kind (64 + 16 images), one epoch, not measured
MIXED_IMAGES = 64
#: [cli idrid]: the paper's IDRiD lesion segmentation (the MA task) on a
#: synthetic tree at the real image size, IDRID_SOURCE (H, W): IDRID_TRAIN
#: + IDRID_TEST images (cut from 54 + 27), fundus discs of radius
#: IDRID_DISC on black, IDRID_SPOTS bright lesions each.  The reader's
#: defaults, but the crop: resized to IDRID_BASE, IDRID_CROP crops at
#: stride IDRID_STRIDE (val: at the crop size), darkness threshold 0.99;
#: RandomPick crops of IDRID_PICK (the shipped config's 448 -> 224), val
#: Partition (2, 2).  The [cli] U-Net in bf16, batch CLI_BATCH, SGD at
#: IDRID_LR (about 8 steps an epoch), the COVID-QU metric set;
#: IDRID_EPOCHS epochs in one process
IDRID_TRAIN, IDRID_TEST, IDRID_SOURCE = 8, 4, (2848, 4288)
IDRID_DISC, IDRID_SPOTS = 1100, 60
IDRID_BASE, IDRID_CROP, IDRID_STRIDE, IDRID_PICK = (1024, 2048), 448, 256, 224
IDRID_LR, IDRID_EPOCHS = 0.05, 3
#: epoch_logs.csv's columns of a one-task run with the Dice loss and the
#: COVID-QU metric set, the JAX CLI's (tests/test_torch_idrid.py)
IDRID_EPOCH_COLUMNS = {
    "epoch", "learning_rate", "dice_loss", "val_dice_loss",
    *(f"{split}metrics/{name}" for split in ("", "val_") for name in (
        "dice_index_threshold_0.5", "jaccard_index_threshold_0.5",
        "mcc_threshold_0.5", "modified_hausdorff_distance_threshold_0.5",
        "area_under_roc", "area_under_roc_pooled"))}
#: the CLI run in a process that reports its peak device memory and peak
#: host memory (``ru_maxrss``, KiB) on its way out
_PEAKS_LAUNCHER = (
    "import atexit, resource, sys\n"
    "import torch\n"
    "from medsegpretrainimagenet_tpu_torch.cli.experiment import main\n"
    "atexit.register(lambda: print(\n"
    "    f'[peaks] {torch.cuda.max_memory_allocated()} '\n"
    "    f'{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}',\n"
    "    file=sys.stderr))\n"
    "main(sys.argv[1:])\n")


def _keep_pattern(batch: int, rate: float):
    """The fed-in drop-path mask: which samples keep a residual branch, a
    fixed pattern per rate."""
    import numpy as np

    return (np.arange(batch) + round(rate * 1000)) % 3 != 0


@contextlib.contextmanager
def fed_drop_paths(calls: list):
    """``blocks.drop_path`` with the masks of :func:`_keep_pattern` on the
    input's device, each call appended to *calls*; restored after."""
    import torch

    from medsegpretrainimagenet_tpu_torch.models import blocks

    original = blocks.drop_path

    def drop_path(x, rate, training, generator):
        if rate == 0.0 or not training:
            return x
        calls.append(rate)
        keep = torch.from_numpy(_keep_pattern(x.shape[0], rate)).to(
            x.device).reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    blocks.drop_path = drop_path
    try:
        yield
    finally:
        blocks.drop_path = original


def phase_blocks_small():
    """[blocks small]: per kind of BLOCK_ZOO, a small float32 U-Net with its
    shortcut, layer scaling 0.1 and stochastic depth 0.1, three steps of
    two fragments of 2 at 64 x 64 on the card and on the CPU from the same
    weights, TF32 off: loss, parameters and running statistics within
    TRAIN_TOL."""
    import torch

    from medsegpretrainimagenet_tpu_torch.models import blocks

    for kind, residual in BLOCK_ZOO:
        cfg = unet_256_train_config(channels=(8, 16, 32))
        cfg["model"]["segmentation.models.UNet"]["architecture"].update({
            "basic_block": f"segmentation.models.blocks.{kind}",
            "width": 2, "residual_connections": residual,
            "layer_scaling": 0.1, "stochastic depth rate": 0.1})
        runs, calls = [], []
        for device in ("cpu", "cuda"):
            model, state, calculator, step = build_trainer(cfg, device)
            check(blocks.draws(model.module),
                  f"[blocks small] {kind}: the U-Net does not draw")
            metrics_state = calculator.init_state(device)
            losses = []
            with tf32_off(), fed_drop_paths(calls):
                for k in range(3):
                    batch = {key: v.to(device) for key, v in
                             segmentation_batch(2, 2, 64, seed=k).items()}
                    state, metrics_state, per_batch = step(
                        state, metrics_state, batch)
                    losses.append(per_batch["dice_loss"].item())
            runs.append((losses, {k: v.double().cpu() for k, v in
                                  model.module.state_dict().items()}))
        (cpu_losses, cpu_state), (losses, state) = runs
        loss_err = max(abs(a - b) for a, b in zip(losses, cpu_losses))
        state_err = {k: (v - cpu_state[k]).abs().max().item()
                     for k, v in state.items()}
        worst = max(state_err, key=state_err.get)
        n_params = sum(v.numel() for k, v in state.items()
                       if not k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked")))
        check(loss_err < TRAIN_TOL and state_err[worst] < TRAIN_TOL
              and len(calls) > 0,
              f"[blocks small] {kind}: card vs CPU loss {loss_err}, {worst} "
              f"{state_err[worst]} (bar {TRAIN_TOL}); {len(calls)} drop "
              f"paths")
        print(f"[blocks small] {kind} U-Net ({n_params} parameters, "
              f"shortcut {residual}, layer scaling 0.1, stochastic depth "
              f"0.1 with {len(calls) // 2} drop paths fed in per run), 3 "
              f"steps of 2 fragments of 2 at 64x64, f32, TF32 off: card vs "
              f"CPU max |diff| loss {loss_err:.3g}, parameters and running "
              f"statistics {state_err[worst]:.3g} ({worst}; bar "
              f"{TRAIN_TOL})", flush=True)


# ---------------------------------------------------------------------------
# block rematerialisation and the half-output LayerNorm
# ---------------------------------------------------------------------------

#: [remat]: unet_256_train's steps held remat on against off, from the same
#: weights on the same batch, before the timed turns of each
REMAT_STEPS = 3
#: the basic blocks of a U-Net, the ones ``blocks.maybe_remat`` wraps
_BASIC_BLOCK = re.compile(
    r"(enc|dec)\.(level_convs\.\d+\.\d+|bottom_convs\.\d+|levels\.\d+\.\d+)")


def _basic_blocks(module) -> int:
    return sum(bool(_BASIC_BLOCK.fullmatch(name))
               for name, _ in module.named_modules())


@contextlib.contextmanager
def counted_checkpoints(calls: list):
    """``blocks.checkpoint`` appending each block it runs to *calls*;
    restored after."""
    from medsegpretrainimagenet_tpu_torch.models import blocks

    real = blocks.checkpoint

    def counted(function, *args, **kwargs):
        calls.append(function)
        return real(function, *args, **kwargs)
    blocks.checkpoint = counted
    try:
        yield
    finally:
        blocks.checkpoint = real


def _small_attention_unet_config(rate: float) -> dict:
    """resnet50_attention_unet_256_train cut to the tests' size
    (tests/torch_port_helpers.py's attention_unet_config): DeepResNet v1
    (8, 16) of widths (1, 1) from a base of 4, decoder (8, 4, 4), the
    ResNet blocks' drop path up to *rate*."""
    cfg = resnet_attention_unet_config()
    arch = cfg["model"]["segmentation.models.UNet"]["architecture"]
    arch["encoder"]["classification.models.DeepResNet"].update(
        channel_sizes=(8, 16), widths=(1, 1), base_channel_size=4,
        stochastic_depth_rate=rate)
    arch["decoder_channels"] = (8, 4, 4)
    return cfg


def _generator_states(module) -> list:
    """The states of the step generators that *module*'s draws took."""
    from medsegpretrainimagenet_tpu_torch.models import blocks

    return [g.get_state() for g in {
        id(m.generator): m.generator for m in module.modules()
        if isinstance(m, blocks.Stochastic) and m.generator is not None
    }.values()]


def phase_remat():
    """[remat]: ``unet_256_train`` at full width in bf16 (31,080,449
    parameters, batch 16, 256 x 256) built twice from the same seed,
    REMAT_STEPS steps on one batch with ``blocks.set_remat`` off and then
    on: the losses, gradient norms and the worst parameter leaf's and
    running statistic's change within [train bf16]'s bars, every basic
    block's forward under checkpoint with remat on and none off; then
    TURNS turns of TURN_STEPS steps each under sync debug mode "error",
    their peak memory (reset before them) lower with remat on, and the
    step ms of both.  Then the small ResNet attention U-Net with remat on,
    card against CPU at [blocks small]'s bar (float32, TF32 off), and on
    the card with the ResNet blocks' drop path drawn from the step's
    generator, remat on against off at that bar with the generator's
    state after the steps the same; the small float32 Swin U-Net with
    remat on, card against CPU at that bar, K1 launched twice a block
    (its forward and the backward's recompute)."""
    import gc

    import torch

    from medsegpretrainimagenet_tpu_torch.models import blocks

    torch.backends.cudnn.benchmark = True
    batch = {k: v.cuda() for k, v in segmentation_batch(
        1, TRAIN_BATCH, TRAIN_SIZE, seed=0).items()}

    def full_width(remat: bool) -> dict:
        blocks.set_remat(remat)
        calls, logs = [], []
        model, state, calculator, step = build_trainer(
            unet_256_train_config(), "cuda")
        start = {k: v.double().cpu() for k, v in
                 model.module.state_dict().items() if v.is_floating_point()}
        metrics_state = calculator.init_state("cuda")

        def run_steps(n):
            nonlocal state, metrics_state
            for _ in range(n):
                state, metrics_state, per_batch = step(state, metrics_state,
                                                       batch)
                logs.append((per_batch["dice_loss"],
                             per_batch["gradient_magnitude"]))

        with counted_checkpoints(calls):
            run_steps(REMAT_STEPS)
            record = _run_record(model.module, logs, start)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            turns = _timed_turns(
                run_steps, f"[remat] a host sync in a step with remat "
                           f"{'on' if remat else 'off'}")
        losses = torch.stack([a for a, _ in logs]).float().cpu()
        check(bool(torch.isfinite(losses).all())
              and losses[-1] < losses[0],
              f"[remat] remat {remat}: losses {losses.tolist()}")
        return {"record": record, "peak": torch.cuda.max_memory_allocated(),
                "step_ms": statistics.median(1e3 * t / TURN_STEPS
                                             for t in turns),
                "checkpoints": len(calls) / len(logs),
                "blocks": _basic_blocks(model.module)}

    blocks.set_compute_dtype(torch.bfloat16)
    try:
        runs = {}
        for remat in (False, True):
            runs[remat] = full_width(remat)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        blocks.set_remat(False)
        blocks.set_compute_dtype(None)
    off, on = runs[False], runs[True]
    read, worst = _bf16_readings(on["record"], off["record"])
    print(f"[remat] unet_256_train bf16, batch {TRAIN_BATCH}, "
          f"{TRAIN_SIZE}x{TRAIN_SIZE}, {REMAT_STEPS} steps from the same "
          f"weights on one batch, remat on against off: relative |diff| "
          + ", ".join(f"{k} {v:.3g} (bar {BF16_TRAIN_TOL[k]})"
                      for k, v in read.items()) + f"; worst {worst}; "
          f"{on['checkpoints']:g} of {on['blocks']} basic blocks under "
          f"checkpoint a step (remat off: {off['checkpoints']:g})",
          flush=True)
    print(f"[remat] {TURNS} turns of {TURN_STEPS} steps each, no host sync "
          f"queued (sync debug mode 'error'): remat off "
          f"{off['step_ms']:.3f} ms a step, peak memory "
          f"{off['peak'] / 2 ** 30:.3f} GiB; remat on {on['step_ms']:.3f} "
          f"ms a step, peak {on['peak'] / 2 ** 30:.3f} GiB "
          f"({100 * on['peak'] / off['peak']:.1f} %); {card_line()}",
          flush=True)
    check(all(read[k] < BF16_TRAIN_TOL[k] for k in read),
          f"[remat] remat on against off: {read} (bars {BF16_TRAIN_TOL})")
    check(on["checkpoints"] == on["blocks"] > 0 and off["checkpoints"] == 0,
          f"[remat] blocks under checkpoint a step: on {on['checkpoints']}"
          f", off {off['checkpoints']}, basic blocks {on['blocks']}")
    check(on["peak"] < off["peak"],
          f"[remat] peak memory with remat on {on['peak']} bytes, off "
          f"{off['peak']}")

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    counters = [getattr(wa, name) for name in _KERNEL_WRAPPERS]

    def small(device: str, remat: bool, cfg: dict, size: int):
        """3 steps of 2 fragments of 2 of the small model of *cfg* at
        *size*: (losses, state, generator states, K1 and K2 launches
        forward and backward)."""
        blocks.set_remat(remat)
        calls, losses = [], []
        for counter in counters:
            counter.launches = 0
        try:
            model, state, calculator, step = build_trainer(cfg, device)
            metrics_state = calculator.init_state(device)
            with tf32_off(), counted_checkpoints(calls):
                for k in range(3):
                    stack = {key: v.to(device) for key, v in
                             segmentation_batch(2, 2, size, seed=k).items()}
                    state, metrics_state, per_batch = step(
                        state, metrics_state, stack)
                    losses.append(per_batch["dice_loss"].item())
        finally:
            blocks.set_remat(False)
        check(bool(calls) == remat, f"[remat] small model ({device}, remat "
                                    f"{remat}): {len(calls)} blocks under "
                                    f"checkpoint")
        return (losses, {k: v.double().cpu() for k, v in
                         model.module.state_dict().items()},
                _generator_states(model.module),
                tuple(c.launches for c in counters))

    def diff(a, b):
        loss = max(abs(x - y) for x, y in zip(a[0], b[0]))
        state_err = {k: (v - b[1][k]).abs().max().item()
                     for k, v in a[1].items()}
        worst = max(state_err, key=state_err.get)
        return loss, worst, state_err[worst]

    attention_unet = (_small_attention_unet_config(0.0), 64)
    cpu_vs_card = diff(small("cuda", True, *attention_unet),
                       small("cpu", True, *attention_unet))
    drawn_on, drawn_off = (small("cuda", remat,
                                 _small_attention_unet_config(0.3), 64)
                           for remat in (True, False))
    on_vs_off = diff(drawn_on, drawn_off)
    same_draws = len(drawn_on[2]) == 1 and all(
        torch.equal(a, b) for a, b in zip(drawn_on[2], drawn_off[2]))
    print(f"[remat] small ResNet attention U-Net, remat on, 3 steps of 2 "
          f"fragments of 2 at 64x64, f32, TF32 off: card vs CPU max |diff| "
          f"loss {cpu_vs_card[0]:.3g}, {cpu_vs_card[1]} {cpu_vs_card[2]:.3g};"
          f" with drop paths up to 0.3 from the card's step generator, "
          f"remat on vs off loss {on_vs_off[0]:.3g}, {on_vs_off[1]} "
          f"{on_vs_off[2]:.3g} (bar {TRAIN_TOL}), generator state after "
          f"the steps the same: {same_draws}", flush=True)
    check(max(cpu_vs_card[0], cpu_vs_card[2], on_vs_off[0], on_vs_off[2])
          < TRAIN_TOL and same_draws,
          f"[remat] small attention U-Net: card vs CPU {cpu_vs_card}, "
          f"remat on vs off with draws {on_vs_off} (bar {TRAIN_TOL}), "
          f"same generator state {same_draws}")

    # the Swin blocks under checkpoint: the backward recomputes K1's
    # forward, so a step launches it twice a block and fragment
    swin = (swin_224_train_config(small=True, rate=0.0), 32)
    card = small("cuda", True, *swin)
    swin_err = diff(card, small("cpu", True, *swin))
    want = 6 * 2 * 3
    print(f"[remat] small f32 Swin U-Net, remat on, 3 steps of 2 fragments "
          f"of 2 at 32x32, TF32 off: card vs CPU max |diff| loss "
          f"{swin_err[0]:.3g}, {swin_err[1]} {swin_err[2]:.3g} (bar "
          f"{TRAIN_TOL}); launches K1, K2, K1 backward, K2 backward "
          f"{card[3]} (want {(2 * want, 0, want, 0)}: the forward and its "
          f"recompute)", flush=True)
    check(max(swin_err[0], swin_err[2]) < TRAIN_TOL
          and card[3] == (2 * want, 0, want, 0),
          f"[remat] small Swin U-Net: card vs CPU {swin_err} (bar "
          f"{TRAIN_TOL}); launches {card[3]}")


_KERNEL_WRAPPERS = ("window_attention_cuda", "image_attention_cuda",
                    "window_attention_backward_cuda",
                    "image_attention_backward_cuda")


@contextlib.contextmanager
def recorded_kernel_calls(calls: dict):
    """Each kernel wrapper of ``ops.window_attention`` appends the
    arguments of its calls to ``calls[name]``; its launch count goes on as
    before (the wrapper adds to it by its module's name, which is the
    recorder's for the while)."""
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    real = {name: getattr(wa, name) for name in _KERNEL_WRAPPERS}

    def recorder(name):
        def record(*args):
            calls.setdefault(name, []).append(args)
            return real[name](*args)
        record.launches = real[name].launches
        return record
    for name in _KERNEL_WRAPPERS:
        setattr(wa, name, recorder(name))
    try:
        yield
    finally:
        for name in _KERNEL_WRAPPERS:
            real[name].launches = getattr(wa, name).launches
            setattr(wa, name, real[name])


def _hold_path_calls(tag: str, calls: dict) -> dict:
    """Hold every recorded kernel call of *calls* against its plain version
    on the same arguments at [swin train]'s bar on the training path's
    calls: the relative max |kernel - plain| of the output, or of each
    gradient the path asks for (dq, dk, dv or dqkv, and dbias), under
    BF16_TOL.  Returns per wrapper (calls, the worst reading)."""
    import torch

    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    plain = {"window_attention_cuda": wa.window_attention_torch,
             "image_attention_cuda": wa.image_attention_torch,
             "window_attention_backward_cuda":
                 lambda *a: wa.window_attention_backward(*a[:7]),
             "image_attention_backward_cuda":
                 lambda *a: wa.image_attention_backward(*a[:6])}
    worst = {}
    with torch.no_grad():
        for name, recorded in calls.items():
            errors = []
            for args in recorded:
                got, want = getattr(wa, name)(*args), plain[name](*args)
                if isinstance(got, torch.Tensor):
                    pairs = [(got, want)]
                else:  # the gradients but dmask, which no step asks for
                    pairs = [(a, b) for a, b in zip(got[:-1], want[:-1])
                             if a is not None]
                errors.append(_rel_err(*zip(*pairs)))
            worst[name] = (len(errors), max(errors))
            check(max(errors) < BF16_TOL,
                  f"[{tag}] {name}: relative max |kernel - plain| "
                  f"{max(errors)} on the path's calls (bar {BF16_TOL})")
    return worst


def _busy_ms(fn, calls: int = 3) -> float:
    """The device time of one call of *fn*: its kernels' time summed by
    torch.profiler over *calls* calls after one more, divided by *calls*
    (the time the device computes, whatever the host's pace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def phase_ln_half(swin_train: dict) -> dict:
    """[ln half]: ``blocks.set_ln_half_out(True)`` (the LayerNorms of
    ``make_layer_norm`` emit the compute dtype) on the Swin U-Net.  (1) The
    small bf16 Swin U-Net, SWIN_SMALL_STEPS steps of two fragments of 2 on
    the card and on the CPU from the same weights, on K1 and on K2: each
    relative |card - CPU| of the losses, gradient norms and worst
    parameter leaf's change within twice the same reading with half-out
    off or under [train bf16]'s bar; the route's launches forward and
    backward.  (2) ``swin_224_train`` on K1 with half-out on, as [swin
    train] times and profiles it, beside [swin train]'s K1 route (half-out
    off): ms a step, device busy ms, launches, the LayerNorm and
    copies-and-permutes groups; then one step on each route with every
    K1 and K2 call, forward and backward, held against its plain version
    at [swin train]'s bar.  (3) ``swin_unet_224`` serving in bf16: the
    device busy ms of a batch's forward (24 images) with half-out on and
    off, on K1 and on K2, the outputs within SERVE_TOL of each other.
    Returns the launches of the K1 turns and of the held steps."""
    import numpy as np
    import torch

    from medsegpretrainimagenet_tpu_torch import ops
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model, blocks
    from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

    counters = [getattr(wa, name) for name in _KERNEL_WRAPPERS]
    small_cfg = swin_224_train_config(small=True, rate=0.0)
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        for route in ("k1", "k2"):
            read, launches = {}, {}
            for half in (False, True):
                blocks.set_ln_half_out(half)
                records = {}
                for device in ("cpu", "cuda"):
                    model, state, calculator, step = build_trainer(small_cfg,
                                                                   device)
                    norms = [m for m in model.module.modules()
                             if isinstance(m, blocks.LayerNorm)]
                    check(norms and all(isinstance(
                        m, blocks.HalfOutLayerNorm) == half for m in norms),
                        f"[ln half] half-out {half}: LayerNorms "
                        f"{sorted({type(m).__name__ for m in norms})}")
                    start = {k: v.double().cpu() for k, v in
                             model.module.state_dict().items()
                             if v.is_floating_point()}
                    metrics_state = calculator.init_state(device)
                    logs = []
                    for counter in counters:
                        counter.launches = 0
                    with attention_route(route):
                        for k in range(SWIN_SMALL_STEPS):
                            stack = {key: v.to(device) for key, v in
                                     segmentation_batch(2, 2, 32,
                                                        seed=k).items()}
                            state, metrics_state, per_batch = step(
                                state, metrics_state, stack)
                            logs.append((per_batch["dice_loss"],
                                         per_batch["gradient_magnitude"]))
                    launches[half] = tuple(c.launches for c in counters)
                    records[device] = _run_record(model.module, logs, start)
                read[half], worst = _bf16_readings(records["cuda"],
                                                   records["cpu"])
            want = 6 * 2 * SWIN_SMALL_STEPS
            expected = (want, 0, want, 0) if route == "k1" \
                else (0, want, 0, want)
            print(f"[ln half] small Swin U-Net bf16, {SWIN_SMALL_STEPS} "
                  f"steps of 2 fragments of 2 at 32x32 on {route}: card vs "
                  f"CPU relative |diff| with half-out on "
                  + ", ".join(f"{k} {v:.3g}" for k, v in read[True].items())
                  + f" ({worst}); with it off "
                  + ", ".join(f"{k} {v:.3g}" for k, v in read[False].items())
                  + f"; launches K1, K2, K1 backward, K2 backward "
                  f"{launches[True]} (want {expected})", flush=True)
            check(all(read[True][k] <= max(2 * read[False][k],
                                           BF16_TRAIN_TOL[k])
                      for k in read[True]) and launches[True] == expected,
                  f"[ln half] small Swin U-Net on {route}: card vs CPU "
                  f"{read[True]} against twice {read[False]} or the bars "
                  f"{BF16_TRAIN_TOL}; launches {launches[True]} (want "
                  f"{expected})")
    finally:
        blocks.set_ln_half_out(False)
        blocks.set_compute_dtype(None)

    held, step_launches = {}, {}

    def hold_one_step_per_route(run_steps):
        for route in ("k1", "k2"):
            calls = {}
            for counter in counters:
                counter.launches = 0
            with attention_route(route), recorded_kernel_calls(calls):
                run_steps(1)
            step_launches[route] = tuple(c.launches for c in counters)
            held.update(_hold_path_calls("ln half", calls))
            del calls

    blocks.set_ln_half_out(True)
    try:
        results = train_cell(
            "ln half swin train", swin_224_train_config(),
            SWIN_TRAIN_BATCH, SWIN_TRAIN_SIZE, 27_166_596, routes=("k1",),
            after=hold_one_step_per_route)["k1"]
    finally:
        blocks.set_ln_half_out(False)
    steps = TURNS * TURN_STEPS
    check(results["k1"] == results["k1_bwd"] == SWIN_BLOCKS * steps
          and results["k2"] == results["k2_bwd"] == 0,
          f"[ln half] K1 turns: launches {results}")
    check(step_launches == {"k1": (14, 0, 14, 0), "k2": (0, 14, 0, 14)},
          f"[ln half] launches in one step per route: {step_launches}")
    for name, (count, err) in held.items():
        print(f"[ln half] {name} on the half-out path: {count} calls of a "
              f"swin_224_train step held against the plain version on "
              f"their arguments: relative max |kernel - plain| {err:.3g} "
              f"(bar {BF16_TOL})", flush=True)
    off, on = swin_train["k1_cell"], results
    groups = ("LayerNorm", "copies and permutes")
    print(f"[ln half] swin_224_train on K1, half-out off / on: "
          f"{off['step_ms']:.3f} / {on['step_ms']:.3f} ms a step, device "
          f"busy {off['profile']['busy_ms']:.3f} / "
          f"{on['profile']['busy_ms']:.3f} ms, "
          f"{off['profile']['launches']:.0f} / "
          f"{on['profile']['launches']:.0f} launches, "
          + ", ".join(f"{g} {off['profile']['groups'].get(g, 0.0):.3f} / "
                      f"{on['profile']['groups'].get(g, 0.0):.3f} ms"
                      for g in groups)
          + f", peak memory {off['peak'] / 2 ** 30:.2f} / "
          f"{on['peak'] / 2 ** 30:.2f} GiB; {card_line()}", flush=True)

    # serving: the same weights with half-out off and on
    modules, weights = {}, None
    for half in (False, True):
        blocks.set_ln_half_out(half)
        try:
            cd = ConfigDict(swin_unet_224_config())
            cd.expand()
            registry.fill_spec(cd, "model")
            model = registry.build(cd, key="model", wrapper=Model)
        finally:
            blocks.set_ln_half_out(False)
        weights = weights if weights is not None else model.init(seed=0)
        model.module.load_state_dict(weights)
        modules[half] = model.module.to("cuda").eval()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (BATCH, 224, 224, 3)).astype(np.float32)).cuda()
    serve_ms, outputs = {}, {}
    blocks.set_compute_dtype(torch.bfloat16)
    try:
        for route in ("k1", "k2"):
            ops.set_fused_image_mode("on" if route == "k2" else "off")
            for half, module in modules.items():
                def forward(module=module):
                    with torch.no_grad():
                        return module(x)
                outputs[route, half] = forward().float()
                serve_ms[route, half] = _busy_ms(forward)
    finally:
        ops.set_fused_image_mode("off")
        blocks.set_compute_dtype(None)
    gaps = {route: (outputs[route, True] - outputs[route, False]).abs()
            .max().item() for route in ("k1", "k2")}
    print(f"[ln half] swin_unet_224 serving, bf16, device busy ms of a "
          f"batch's forward ({BATCH} images), half-out off / on: K1 "
          f"{serve_ms['k1', False]:.3f} / {serve_ms['k1', True]:.3f}, K2 "
          f"{serve_ms['k2', False]:.3f} / {serve_ms['k2', True]:.3f}; max "
          f"|on - off| of the sigmoid outputs K1 {gaps['k1']:.3g}, K2 "
          f"{gaps['k2']:.3g} (bar {SERVE_TOL}); {card_line()}", flush=True)
    check(all(g < SERVE_TOL for g in gaps.values()),
          f"[ln half] serving outputs half-out on vs off: {gaps} (bar "
          f"{SERVE_TOL})")
    return {"launches": results["k1"], "bwd_launches": results["k1_bwd"],
            "step_launches": step_launches}


def mixed_config(workdir: Path) -> dict:
    """[cli mixed]'s config: the [cli] config (not measured) for one epoch
    of a MixedDataset of two COVID-QU readers of the same tree, one
    validating on the test split and one on a random split, switching every
    2 records in shuffled order, over-balanced in train and under-balanced
    in val, reloaded lazily, with two loader workers asked for."""
    cfg = cli_config(workdir, 1, measured=False)
    reader = cfg["data"]["data"].pop("segmentation.datasets.COVIDQUDataset")
    cfg["data"]["data"]["data.MixedDataset"] = {
        "datasets": tuple(
            {"segmentation.datasets.COVIDQUDataset": {
                **reader, "validate_on_test": on_test}}
            for on_test in (True, False)),
        "switch_frequency": 2, "preserve_order": False,
        "balancing_strategy": {"train": "over", "val": "under"},
        "preload_data": False}
    cfg["meta"]["technical"]["number_of_data_loader_workers"] = 2
    return cfg


def phase_cli_mixed(workdir: Path) -> None:
    """[cli mixed]: the CLI in a process of its own on mixed_config, one
    epoch, not measured: exit 0, nothing through the error envelope, the
    batch count of the union, finite logs; in this process, the same
    MixedDataset and loader keep the stateful loads serial (no worker
    pool)."""
    import os

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.data import BalancedDataLoader
    from medsegpretrainimagenet_tpu_torch.data.sampling import \
        StatefulLoadFunctions

    t0 = time.perf_counter()
    workdir.mkdir()
    write_covidqu_tree(workdir / "data", images=MIXED_IMAGES)
    cfg = mixed_config(workdir)
    os.environ["MST_DATA_DIR"] = str(workdir / "data")
    cd = ConfigDict({"data": cfg["data"]["data"]})
    cd.expand()
    registry.fill_spec(cd, "data")
    mixed = registry.build(cd["data"].trim(), seed=777)
    sampling = ConfigDict({"sampling": {"batch size": CLI_BATCH}})
    BalancedDataLoader.fill_kwargs(sampling["sampling"])
    loader = BalancedDataLoader(mixed.train, sampling["sampling/train"],
                                bs=CLI_BATCH, actual_bs=CLI_BATCH, seed=777,
                                load_function=mixed.load_function,
                                num_workers=2)
    check(isinstance(mixed.load_function, StatefulLoadFunctions)
          and loader._load_executor() is None,
          "[cli mixed] the loader would run MixedDataset's stateful loads "
          "on its worker pool")
    seconds = _run_cli(workdir, cfg)
    (run,) = (workdir / "logs").glob("*/Experiment/run_1")
    rows = _csv_rows(run / "epoch_logs.csv")
    batch_rows = _csv_rows(run / "batch_logs.csv")
    check(len(rows) == 1 and set(rows[0]) == CLI_EPOCH_COLUMNS
          and len(batch_rows) == len(loader)
          and all(math.isfinite(float(v)) for r in rows + batch_rows
                  for v in r.values()),
          f"[cli mixed] {len(rows)} epoch rows {rows}, {len(batch_rows)} "
          f"batch rows (want {len(loader)})")
    print(f"[cli mixed] MixedDataset of two COVID-QU readers ({mixed.train_ds_sizes} "
          f"train and {mixed.val_ds_sizes} val records; validate_on_test "
          f"and a random split), switch every 2 records, over / under, "
          f"lazy reloads, 2 loader workers asked for and refused: 1 epoch "
          f"of {len(mixed.train['x'])} records ({len(batch_rows)} batches) "
          f"in {seconds:.1f} s of wall time; dice_loss "
          f"{rows[0]['dice_loss']}, val Dice "
          f"{rows[0]['val_metrics/dice_index_threshold_0.5']}", flush=True)
    print(f"[cli mixed] {time.perf_counter() - t0:.1f} s", flush=True)


def write_idrid_tree(root: Path, seed: int = 0) -> None:
    """The IDRiD layout under *root*/idrid at the real image size: fundus
    ``.jpg`` files (an orange disc of radius IDRID_DISC, darker towards its
    rim, with noise, on black, so that the corner crops fall under the
    darkness filter) and ``1. Microaneurysms`` ``.tif`` masks of IDRID_SPOTS
    bright round lesions painted into each image."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = IDRID_SOURCE
    base = root / "idrid" / "Segmentation" / "A. Segmentation"
    yy, xx = np.ogrid[:h, :w]
    r2 = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2).astype(np.float32) \
        / IDRID_DISC ** 2
    shade = np.where(r2 < 1, 1 - 0.35 * r2, 0)[..., None]
    fundus = shade * np.array([200, 95, 40], np.float32)
    fundus = np.clip(fundus + shade * rng.normal(0, 6, fundus.shape)
                     .astype(np.float32), 0, 255).astype(np.uint8)
    idx = 1
    for part, n in (("a. Training Set", IDRID_TRAIN),
                    ("b. Testing Set", IDRID_TEST)):
        img_dir = base / "1. Original Images" / part
        mask_dir = base / "2. All Segmentation Groundtruths" / part \
            / "1. Microaneurysms"
        img_dir.mkdir(parents=True)
        mask_dir.mkdir(parents=True)
        for _ in range(n):
            img = fundus.copy()
            mask = np.zeros((h, w), np.uint8)
            for _ in range(IDRID_SPOTS):
                rho = IDRID_DISC * 0.85 * np.sqrt(rng.random())
                phi = 2 * np.pi * rng.random()
                cy, cx = int(h / 2 + rho * np.sin(phi)), \
                    int(w / 2 + rho * np.cos(phi))
                rad = int(rng.integers(10, 28))
                py, px = np.ogrid[-rad:rad + 1, -rad:rad + 1]
                spot = py ** 2 + px ** 2 <= rad ** 2
                sl = (slice(cy - rad, cy + rad + 1),
                      slice(cx - rad, cx + rad + 1))
                img[sl][spot] = (250, 235, 150)
                mask[sl][spot] = 255
            Image.fromarray(img).save(img_dir / f"IDRiD_{idx:02d}.jpg",
                                      quality=90)
            Image.fromarray(mask).save(mask_dir / f"IDRiD_{idx:02d}_MA.tif")
            idx += 1


def idrid_config(workdir: Path, epochs: int) -> dict:
    """[cli idrid]'s config: the IDRiD reader (the MA task) and its
    transforms in place of [cli]'s COVID-QU reader, the COVID-QU metric
    set, SGD at IDRID_LR, no cuDNN autotuning."""
    cfg = cli_config(workdir, epochs)
    cfg["data"] = {
        "data": {"segmentation.datasets.IDRiD": {
            "task": "MA", "base_image_sizes": IDRID_BASE,
            "cropped_image_sizes": IDRID_CROP,
            "train_crop_stride": (IDRID_STRIDE, IDRID_STRIDE),
            "darkness_threshold": 0.99, "validation_set": "test",
            "train_set_size": IDRID_TRAIN}},
        "sampling": {"batch_size": CLI_BATCH},
        "transforms": {
            "train": (
                {"segmentation.transforms.wrapped_transforms.RandomPick": {
                    "crop_size": IDRID_PICK}},
                {"segmentation.transforms.wrapped_transforms.RandomFlip": {}}),
            "val": {"segmentation.transforms.wrapped_transforms.Partition": {
                "number_of_partitions": (2, 2), "size": IDRID_PICK}},
            "casting": {"mask": "torch.LongTensor"}}}
    cfg["training"]["optimizer"]["sgd"]["learning_rate"]["constant"][
        "base"] = IDRID_LR
    # no cuDNN autotuning: a large part of the first epoch, whose steps
    # the host's crops pace anyway
    cfg["meta"]["technical"]["use_cudnn_benchmarking"] = False
    cfg["metrics"] = {"metrics": COVIDQU_METRICS}
    return cfg


def _rss_bytes() -> int:
    """This process's resident memory now (Linux ``VmRSS``)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return 1024 * int(line.split()[1])
    return 0


def _idrid_reader(workdir: Path):
    """The port's IDRiD reader on the tree with [cli idrid]'s settings, in
    this process, with its host seconds: the whole read, and for the first
    training image its decode, its resize and its mask's decode and
    resize.  Returns (dataset, seconds)."""
    import os

    import numpy as np
    from PIL import Image

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.data import warp
    from medsegpretrainimagenet_tpu_torch.data.readers import IDRiD

    os.environ["MST_DATA_DIR"] = str(workdir / "data")
    base = workdir / "data" / "idrid" / "Segmentation" / "A. Segmentation"
    seconds = {}
    t0 = time.perf_counter()
    with Image.open(base / "1. Original Images" / "a. Training Set"
                    / "IDRiD_01.jpg") as image:
        arr = np.asarray(image)[:, 96:-96] / 255
    seconds["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warp.resize(arr, IDRID_BASE)
    seconds["resize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with Image.open(base / "2. All Segmentation Groundtruths"
                    / "a. Training Set" / "1. Microaneurysms"
                    / "IDRiD_01_MA.tif") as image:
        mask = np.asarray(image)[:, 96:-96]
    warp.resize(mask, IDRID_BASE)
    seconds["mask"] = time.perf_counter() - t0
    cfg = idrid_config(workdir, 1)["data"]["data"][
        "segmentation.datasets.IDRiD"]
    t0 = time.perf_counter()
    dataset = IDRiD(ConfigDict(cfg), seed=777)
    seconds["read"] = time.perf_counter() - t0
    return dataset, seconds


def _idrid_host_assembly(workdir: Path, dataset) -> float:
    """Host ms per assembled train batch of [cli idrid]'s own chain
    (RandomPick's rotated crops, the flip, the cast) and loader."""
    import itertools

    from medsegpretrainimagenet_tpu_torch.cli.run_experiment import \
        build_transform_pipelines
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict
    from medsegpretrainimagenet_tpu_torch.data import BalancedDataLoader

    cd = ConfigDict(idrid_config(workdir, 1))
    cd.expand()
    pipeline = build_transform_pipelines(cd, seed=1)[0]
    sampling = ConfigDict({"sampling": {"batch size": CLI_BATCH}})
    BalancedDataLoader.fill_kwargs(sampling["sampling"])
    loader = BalancedDataLoader(dataset.train, sampling["sampling/train"],
                                bs=CLI_BATCH, actual_bs=CLI_BATCH,
                                transforms=pipeline, seed=1)
    batches = iter(loader)
    t0 = time.perf_counter()
    got = list(itertools.islice(batches, 4))
    ms = 1e3 * (time.perf_counter() - t0) / len(got)
    batch = got[0]
    check(batch["x"].shape == (CLI_BATCH, IDRID_PICK, IDRID_PICK, 3)
          and batch["mask"].shape == (CLI_BATCH, IDRID_PICK, IDRID_PICK),
          f"[cli idrid] assembled batch "
          f"{[(k, v.shape, v.dtype) for k, v in batch.items()]}")
    return ms


def phase_cli_idrid(workdir: Path, step_rate: float) -> None:
    """[cli idrid]: the paper's IDRiD U-Net through the experiment CLI in a
    process of its own on a synthetic tree at the real image size,
    IDRID_EPOCHS epochs in one process (the resume under --continued
    is [cli]'s and [cli acdc]'s: a process of its own re-read the images
    in 43 s of the script's time): exit 0 with
    nothing through the error envelope, the batches the reader's crop
    count gives, the JAX CLI's columns, ``.pt`` files that load, the train
    Dice loss falling and the val Dice finite and rising; the reader's
    host seconds, the host assembly per batch, the epochs' images/s beside
    [train]'s and the CLI process's peak memory."""
    import torch

    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    card = card_line()
    workdir.mkdir()
    write_idrid_tree(workdir / "data")
    images = IDRID_TRAIN + IDRID_TEST
    print(f"[cli idrid] synthetic IDRiD tree: {IDRID_TRAIN} + {IDRID_TEST} "
          f"fundus images of {IDRID_SOURCE[0]}x{IDRID_SOURCE[1]} with MA "
          f"masks in {time.perf_counter() - t0:.1f} s", flush=True)

    rss = _rss_bytes()
    dataset, reader_s = _idrid_reader(workdir)
    held = _rss_bytes() - rss
    kept, dropped = dataset.kept, dataset.dropped
    # crops per image on the reader's grid (train at the stride, val at
    # the crop size), before the darkness filter
    grid = {split: n * math.prod((b - IDRID_CROP) // step + 1
                                 for b in IDRID_BASE)
            for split, n, step in (("train", IDRID_TRAIN, IDRID_STRIDE),
                                   ("val", IDRID_TEST, IDRID_CROP))}
    check(all(kept[s] + dropped[s] == grid[s] and kept[s] > 0
              for s in grid) and dropped["train"] > 0,
          f"[cli idrid] crops kept {kept}, dropped {dropped} of {grid}")
    print(f"[cli idrid] reader (this process; {card}): {images} images "
          f"in {reader_s['read']:.2f} s of host time = "
          f"{reader_s['read'] / images:.3f} s per image (first image: "
          f"decode {reader_s['decode']:.3f} s, resize "
          f"{reader_s['resize']:.3f} s, mask decode and resize "
          f"{reader_s['mask']:.3f} s); {IDRID_CROP}x{IDRID_CROP} crops "
          f"kept / dropped by the darkness filter: train {kept['train']} / "
          f"{dropped['train']}, val {kept['val']} / {dropped['val']}; the "
          f"dataset adds {held / 2 ** 30:.2f} GiB to this process's "
          f"resident memory", flush=True)
    assembly_ms = _idrid_host_assembly(workdir, dataset)
    print(f"[cli idrid] host assembly {assembly_ms:.1f} ms per train batch "
          f"of {CLI_BATCH} (RandomPick's rotated {IDRID_PICK}x{IDRID_PICK} "
          f"crops, flip, cast; {card})", flush=True)
    del dataset

    steps = -(-kept["train"] // CLI_BATCH)
    cd = ConfigDict({"model": idrid_config(workdir, 1)["model"]})
    cd.expand()
    registry.fill_spec(cd, "model")
    module = registry.build(cd, key="model", wrapper=Model).module
    epochs = IDRID_EPOCHS
    wall, out = _cli_process(workdir, idrid_config(workdir, epochs),
                             launcher=_PEAKS_LAUNCHER)
    marks = [m for m in ENVELOPE_MARKS if m in out.stderr]
    check(out.returncode == 0 and not marks,
          f"[cli idrid] exit {out.returncode}, envelope marks {marks}; "
          f"stderr tail:\n{out.stderr[-4000:]}")
    found = re.findall(r"\[peaks\] (\d+) (\d+)", out.stderr)
    check(bool(found), "[cli idrid] the run reported no peaks")
    peaks = [int(v) for v in found[-1]]
    (run,) = (workdir / "logs").glob("*/Experiment/run_1")
    rows = _csv_rows(run / "epoch_logs.csv")
    check(len(rows) == epochs and set(rows[0]) == IDRID_EPOCH_COLUMNS
          and len(_csv_rows(run / "batch_logs.csv")) == steps * epochs
          and all(math.isfinite(float(v)) for r in rows
                  for v in r.values()),
          f"[cli idrid] {len(rows)} epoch rows (want {epochs}), "
          f"{len(_csv_rows(run / 'batch_logs.csv'))} batch rows (want "
          f"{steps} per epoch), columns "
          f"{sorted(rows[0]) if rows else None}: {rows}")
    for name in ("last_model_state_dict.pt", "best_model_state_dict.pt"):
        module.load_state_dict(ckpt.load_params_file(run / name))
    saved = ckpt.load_state_file(run / "optimizer_state_dict.pt")
    check(saved["step"] == steps * IDRID_EPOCHS
          and ckpt.load_params_file(run / "checkpoint_epoch.pt")
          == {"epoch": IDRID_EPOCHS},
          f"[cli idrid] optimizer step {saved['step']}")
    loss = [float(r["dice_loss"]) for r in rows]
    dice = [float(r["val_metrics/dice_index_threshold_0.5"]) for r in rows]
    check(loss[-1] < loss[0] and dice[-1] > dice[0],
          f"[cli idrid] train Dice loss {loss} falling, val Dice {dice} "
          f"rising")
    print(f"[cli idrid] {epochs} epochs in {wall:.1f} s of wall time "
          f"(process and reading included); "
          f"{steps} steps of {CLI_BATCH} an epoch; train Dice loss "
          f"{[round(v, 4) for v in loss]}, val Dice "
          f"{[round(v, 4) for v in dice]}, val HD95 "
          f"{[r['val_metrics/modified_hausdorff_distance_threshold_0.5'] for r in rows]}"
          f", val AUROC {[r['val_metrics/area_under_roc'] for r in rows]}",
          flush=True)
    for row in _csv_rows(run / "profile" / "epoch_times.csv"):
        train_s = float(row["train_s"])
        rate = kept["train"] / train_s
        print(f"[cli idrid] epoch {row['epoch']}: train {train_s:.3f} s = "
              f"{rate:.1f} images/s of {IDRID_PICK}x{IDRID_PICK} "
              f"({100 * rate / step_rate:.1f} % of [train]'s "
              f"{step_rate:.1f} step-only images/s at 256x256), val "
              f"{float(row['val_s']):.3f} s, checkpoints "
              f"{float(row['ckpt_s']):.3f} s; {card}", flush=True)
    print(f"[cli idrid] the run's process: peak device memory "
          f"{peaks[0] / 2 ** 30:.2f} GiB, peak host memory "
          f"{peaks[1] / 2 ** 20:.2f} GiB; {card}", flush=True)
    del module
    torch.cuda.empty_cache()
    print(f"[cli idrid] {time.perf_counter() - t0:.1f} s", flush=True)


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

    timed("build", phase_build)
    k1, k1_bound_by, k1_err = timed("k1", phase_k1)
    k2, k2_bound_by, k2_err, k2_bands = timed("k2", phase_k2)
    bwd = timed("k bwd", phase_bwd)
    with tempfile.TemporaryDirectory() as tmp:
        timed("small", phase_small_vs_cpu)
        k1_launches, k2_launches = timed("serve", phase_serve, Path(tmp))
        exported = timed("export", phase_export, Path(tmp))
    timed("train small", phase_train_small)
    timed("train bf16", phase_train_bf16)
    step_rate = timed("train", phase_train_full)
    timed("remat", phase_remat)
    timed("metrics", phase_metrics, step_rate)
    timed("cli", phase_cli, step_rate)
    timed("ddp", phase_ddp, step_rate)
    par = timed("parallel", phase_parallel)
    timed("cli acdc", phase_cli_acdc, step_rate)
    timed("pretrain small", phase_pretrain_small)
    pretrain_rate = timed("pretrain", phase_pretrain_full)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        encoder = timed("cli pretrain", phase_cli_pretrain, Path(tmp),
                        pretrain_rate)
        timed("cli transfer", phase_cli_transfer, Path(tmp), encoder)
        timed("robustness small", phase_robustness_small)
        rob = timed("robustness", phase_robustness, Path(tmp), encoder)
        timed("swin train small", phase_swin_train_small)
        swin_train = timed("swin train", phase_swin_train)
        ln_half = timed("ln half", phase_ln_half, swin_train)
        timed("resnet train", phase_resnet_train)
        cli_swin_launches = timed("cli swin", phase_cli_family,
                                  Path(tmp) / "cli_swin", "swin")
        timed("cli resnet", phase_cli_family, Path(tmp) / "cli_resnet",
              "resnet")
        timed("blocks small", phase_blocks_small)
        timed("cli mixed", phase_cli_mixed, Path(tmp) / "cli_mixed")
        timed("cli idrid", phase_cli_idrid, Path(tmp) / "cli_idrid",
              step_rate)

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
    # training (swin_224_train, bf16): the forward kernel's launches in the
    # timed steps of its route, and the attention of one step forward and
    # backward, the kernel pair (the forward kernel + its backward kernel)
    # beside the pair with the plain recompute backward, plain autograd and
    # SDPA (for K2 with the layout permutes), with its bound, and its
    # errors against plain autograd (the outputs, the gradients); K1's
    # launches in [cli swin]'s no-grad validation pass
    for entry, pair, launches in (
            (kernels[0], swin_train["pair"], swin_train["launches"]),
            (kernels[1], swin_train["k2_pair"], swin_train["k2_launches"])):
        entry.update({
            "swin_train_launches": launches,
            "swin_train_ms": pair["ms"],
            "swin_train_recompute_ms": pair["recompute_ms"],
            "swin_train_plain_ms": pair["plain_ms"],
            "swin_train_library_ms": pair["sdpa_ms"],
            "swin_train_bound_ms": pair["bound_ms"],
            "swin_train_bound_by": pair["bound_by"],
            "swin_train_fwd_rel_err": pair["fwd_err"],
            "swin_train_bwd_rel_err": pair["bwd_err"]})
    kernels[0].update({
        "cli_swin_val_launches": cli_swin_launches,
        # [tp]: K1's launches per swin_224_train step with its qkv
        # column-parallel over two ranks; [pp]: per pipeline tick of two
        # DoubleSwin stages (one per Swin block)
        "tp_swin_train_launches": par["tp_swin_train_launches"],
        "pp_launches_per_tick": par["pp_launches_per_tick"],
        # [sp]: per rank per swin_224_train step on two bands of rows
        "sp_swin_train_launches": par["sp_swin_k1_launches"]})
    # [ln half]: per swin_224_train step with the half-output LayerNorms,
    # K1's in the timed turns, K2's in the one step held on its route
    kernels[0]["ln_half_swin_train_launches"] = ln_half["launches"]
    kernels[1]["ln_half_swin_train_launches"] = \
        ln_half["step_launches"]["k2"][1]
    kernels[1].update({
        "sp_swin_train_launches": par["sp_swin_k2_launches"],
        # [k2 band]: the instances on bands of rows (swin_224_train's
        # level 0 at batch 8 on 2 and 4 bands, SW-MSA with the last band's
        # mask rows) beside the square one at that batch, each dtype
        "bands": k2_bands})
    # [export]: launches in one forward (batch 24) of the loaded artifact,
    # K1's on the windows layout, K2's under set_fused_image_mode("on"),
    # with the operator nodes of its graph
    for entry, op in zip(kernels, ("window_attention", "image_attention")):
        entry.update({"export_launches": exported[op]["launches"],
                      "export_nodes": exported[op]["nodes"]})
    # the float32 instances: the 8 calls of one Swin encoder forward of
    # robustness_224, summed, L2-cold (warm_ms: warm inputs); launches from
    # the in-process sweep (K2's with set_fused_image_mode("on")); the
    # library call is SDPA in float32 (for K2 with the layout permutes)
    att = rob["attention"]
    for kernel, name, line in (("k1", "window_attention", 81),
                               ("k2", "image_attention", 266)):
        kernels.append({
            "name": f"{name}_f32",
            "route": "cuda",
            "source": f"medsegpretrainimagenet_tpu_torch/csrc/{name}.cu",
            "replaces": f"medsegpretrainimagenet_tpu/ops/window_attention.py:"
                        f"{line}",
            "launches": rob[kernel],
            "max_abs_err": att[f"{kernel}_err"],
            "ms": att[f"{kernel}_ms"], "warm_ms": att[f"{kernel}_warm_ms"],
            "plain_ms": att[f"{kernel}_plain_ms"],
            "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
            "library_ms": att[f"{kernel}_sdpa_ms"],
        })
    # the backward kernels ([k1 bwd], [k2 bwd]): the 14 calls of one
    # swin_224_train step at batch 24, the backward alone (dbias asked
    # for, as training asks), summed, L2-cold; library_ms: SDPA's backward
    # (K2: with the layout permutes); max_abs_err over the gradients of
    # the inputs at every shape (dbias and dmask, relative to their
    # largest value: table_rel_err).  bf16 launches: per route of the
    # timed swin_224_train steps; float32: per step of [tp]'s and [sp]'s
    # float32 swin_224_train (per rank), and per pipeline tick ([pp])
    for kernel, name, line in (("k1", "window_attention", 81),
                               ("k2", "image_attention", 266)):
        for dtype, suffix in (("torch.bfloat16", ""), ("torch.float32",
                                                       "_f32")):
            reading = bwd[kernel, dtype]
            entry = {
                "name": f"{name}_bwd{suffix}",
                "route": "cuda",
                "source": f"medsegpretrainimagenet_tpu_torch/csrc/"
                          f"{name}_bwd.cu",
                "replaces": f"medsegpretrainimagenet_tpu/ops/"
                            f"window_attention.py:{line}",
                "max_abs_err": reading["max_abs_err"],
                "table_rel_err": reading["table_err"],
                "ms": reading["ms"], "plain_ms": reading["plain_ms"],
                "bound_ms": reading["bound_ms"],
                "bound_by": reading["bound_by"],
                "library_ms": reading["library_ms"],
                "smem_bytes": reading["smem_bytes"],
                "warps_per_sm": 4 * reading["blocks_per_sm"]}
            if suffix:
                entry["launches"] = par[f"sp_swin_{kernel}_bwd_launches"]
                if kernel == "k1":
                    entry["tp_swin_train_launches"] = \
                        par["tp_swin_train_bwd_launches"]
                    entry["pp_launches_per_tick"] = \
                        par["pp_bwd_launches_per_tick"]
            else:
                entry["launches"] = swin_train[
                    "bwd_launches" if kernel == "k1" else "k2_bwd_launches"]
                entry["ln_half_swin_train_launches"] = \
                    ln_half["bwd_launches"] if kernel == "k1" \
                    else ln_half["step_launches"]["k2"][3]
            kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--only", "parallel"]:
        sys.exit(main_parallel())
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: run with none, or with "
             f"--only parallel (four cards)")
    sys.exit(main())
