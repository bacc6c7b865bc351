"""The transferability sweep on the card against the CPU: a small sweep
over the three encoder families (a narrow U-Net encoder, a narrow ResNet
v1 bottleneck, a Swin encoder with window 7) gives the same levels (within
1e-4 of their largest value) and rows (within 1e-5) on the card as on the
CPU, with TF32 off and the same jitter draws; K1 and K2 in float32 agree
with their plain versions at the Swin encoder's level shapes at 224
(chip_smoke.py's [k1] f32 bars), and the encoder's forward launches K1 (or
K2 under ``set_fused_image_mode("on")``) once per attention call.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_robustness_gpu.py -q
"""
import copy
import warnings

import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu_torch import ops
from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.models.swin import (
    _relative_position_index, _shift_attn_mask)
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa
from medsegpretrainimagenet_tpu_torch.robustness import eval as rob_eval
from medsegpretrainimagenet_tpu_torch.robustness import sweep
from medsegpretrainimagenet_tpu_torch.robustness.__main__ import (
    build_encoders)

pytestmark = pytest.mark.gpu

LEVEL_TOL, ROW_TOL = 1e-4, 1e-5
MAX_TOL, MEAN_TOL = 1e-4, 1e-6
SIZE, PROBES = 56, 4
ENCODERS = [
    {"name": "u-net_encoder", "model": {"segmentation.models.UNet_encoder": {
        "in_channel_size": 3, "channels": (8, 16, 32, 64), "depth": 3}}},
    {"name": "resnet50", "model": {"classification.models.DeepResNet": {
        "bias": False, "version": "v1", "channel_sizes": (32, 64, 128),
        "widths": (1, 1, 1), "base_channel_size": 8}}},
    {"name": "swin_transformer", "model": {
        "segmentation.models.UNet_encoder": {
        "in_channel_size": 3, "channels": (16, 32, 64),
        "change_channel_in_block": False, "depth": 2, "width": 2,
        "trainable_downsampling": True, "stochastic_depth_rate": 0.1,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": SIZE, "patch_size": 2, "embed_dim": 16,
            "num_heads_layers": (1, 2, 4), "window_size": 7}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {
            "patch_size": 2}}}}},
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test holds the card against "
                    "the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoders(probes):
    cpu = build_encoders(ConfigDict({"encoders": ENCODERS}),
                         {"probe": probes}, 0, torch.device("cpu"))
    card = [dict(e, module=copy.deepcopy(e["module"]).cuda()) for e in cpu]
    return cpu, card


def _relative(got, ref):
    return ((got.cpu() - ref).abs().max() / ref.abs().max()).item()


def test_small_sweep_card_matches_cpu(cuda_device):
    probes = np.random.default_rng(0).random(
        (PROBES, SIZE, SIZE, 1)).astype(np.float32)
    cpu, card = _encoders(probes)
    draws = sweep.dataset_draws(0, 0)
    view = rob_eval.apply_color_jitter(torch.from_numpy(probes), draws[0])
    for c, g in zip(cpu, card):
        x = sweep.adapt_channels(view, c["in_channels"])
        ref = rob_eval.collect_levels(c["module"], x)
        got = rob_eval.collect_levels(g["module"], x.to(cuda_device))
        want = 3 if c["name"] == "swin_transformer" else 4
        assert len(got) == len(ref) == want
        for level, (a, b) in enumerate(zip(got, ref)):
            assert _relative(a, b) < LEVEL_TOL, (c["name"], level)
    axes = dict(metrics=("cosine_distance", "l2", "inv_pearson"),
                margins=(0.0, 0.5, 1.0), levels=(1, 2, 3), pooled=(False,
                                                                   True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_rows = sweep.run_sweep(cpu, {"probe": probes},
                                   draws={"probe": draws}, **axes)
        rows = sweep.run_sweep(card, {"probe": probes},
                               draws={"probe": draws}, **axes)
    assert len(rows) == len(ref_rows) == 3 * 3 * 2 * (3 + 3 + 2)
    for a, b in zip(rows, ref_rows):
        assert np.isfinite(a["robustness"])
        assert abs(a["robustness"] - b["robustness"]) < ROW_TOL, (a, b)


@pytest.mark.parametrize("mode, kernel", [("off", "window_attention_cuda"),
                                          ("on", "image_attention_cuda")])
def test_swin_encoder_launches_its_kernel(cuda_device, mode, kernel):
    """W-MSA and SW-MSA at levels 0 and 1 (28 x 28 and 14 x 14 tokens,
    window 7) and two W-MSA at the bottom (7 x 7, one window): 6 launches
    of the path's kernel per forward, none of the other."""
    probes = np.random.default_rng(1).random(
        (PROBES, SIZE, SIZE, 3)).astype(np.float32)
    cpu, card = _encoders(probes)
    x = torch.from_numpy(probes)
    ref = rob_eval.collect_levels(cpu[2]["module"], x)
    wa.window_attention_cuda.launches = 0
    wa.image_attention_cuda.launches = 0
    ops.set_fused_image_mode(mode)
    try:
        got = rob_eval.collect_levels(card[2]["module"], x.to(cuda_device))
    finally:
        ops.set_fused_image_mode("off")
    other = "image_attention_cuda" if mode == "off" \
        else "window_attention_cuda"
    assert getattr(wa, kernel).launches == 6
    assert getattr(wa, other).launches == 0
    for a, b in zip(got, ref):
        assert _relative(a, b) < LEVEL_TOL


#: the Swin encoder's attention calls at 224 (robustness_224): level,
#: heads, windows per image, shifted; for two probes
SHAPES = [(0, 3, 64, False), (0, 3, 64, True), (1, 6, 16, False),
          (1, 6, 16, True), (2, 12, 4, False), (2, 12, 4, True),
          (3, 24, 1, False)]


@pytest.mark.parametrize("level, heads, n_w, masked", SHAPES)
def test_f32_kernels_match_plain_at_the_encoder_shapes(cuda_device, level,
                                                       heads, n_w, masked):
    gen = torch.Generator().manual_seed(level)
    res, window, dim = 56 // 2 ** level, 7, 32
    table = torch.randn(13 * 13, heads, generator=gen) * 0.02
    index = torch.from_numpy(_relative_position_index((window, window)))
    bias = table[index.reshape(-1)].reshape(49, 49, heads).permute(
        2, 0, 1).contiguous().to(cuda_device)
    mask = torch.from_numpy(_shift_attn_mask((res, res), window, 3)).to(
        cuda_device) if masked else None
    scale = dim ** -0.5
    q, k, v = (torch.randn(2 * n_w, heads, 49, dim, generator=gen).to(
        cuda_device) for _ in range(3))
    diff = (wa.window_attention_cuda(q, k, v, bias, mask, scale)
            - wa.window_attention_torch(q, k, v, bias, mask, scale)).abs()
    assert diff.max().item() < MAX_TOL and diff.mean().item() < MEAN_TOL
    qkv = torch.randn(2, res, res, 3 * heads * dim, generator=gen).to(
        cuda_device)
    diff = (wa.image_attention_cuda(qkv, bias, mask, scale, window)
            - wa.image_attention_torch(qkv, bias, mask, scale, window)).abs()
    assert diff.max().item() < MAX_TOL and diff.mean().item() < MEAN_TOL
