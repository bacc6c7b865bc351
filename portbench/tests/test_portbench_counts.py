"""The yardstick's counts against hand counts: model FLOPs from the
reference's shapes on the meta device, K1's byte bounds."""
import math

import pytest
import torch

from portbench import bounds, flops, spec


def unet_leaves(channels=(64, 128, 256, 512, 1024), cin=3):
    leaves = {"enc.stem_block.Conv_0.weight": (channels[0], cin, 3, 3),
              "enc.stem_block.Conv_0.bias": (channels[0],)}
    depth = len(channels) - 1
    chain = [channels[0]] + list(channels)

    def block(name, a, b):
        for i, (x, y) in enumerate(((a, b), (b, b))):
            leaves[f"{name}.Conv_{i}.weight"] = (y, x, 3, 3)
            leaves[f"{name}.Conv_{i}.bias"] = (y,)
            for k in ("weight", "bias", "running_mean", "running_var"):
                leaves[f"{name}.BatchNorm_{i}.{k}"] = (y,)
    for i in range(depth):
        block(f"enc.level_convs.{i}.0", chain[i], chain[i + 1])
    block("enc.bottom_convs.0", chain[depth], chain[depth + 1])
    rev = list(channels)[::-1]
    for i in range(depth):
        leaves[f"dec.upsamples.{i}.Conv_0.weight"] = (rev[i] // 2, rev[i],
                                                     2, 2)
        leaves[f"dec.upsamples.{i}.Conv_0.bias"] = (rev[i] // 2,)
        block(f"dec.level_convs.{i}.0", rev[i], rev[i + 1])
    leaves["dec.final.Conv_0.weight"] = (1, channels[0], 1, 1)
    leaves["dec.final.Conv_0.bias"] = (1,)
    return leaves


def hand_unet_macs(size=256, channels=(64, 128, 256, 512, 1024)):
    """Multiply-adds of one 256 x 256 image, layer by layer."""
    macs = size * size * channels[0] * 3 * 9          # stem
    first = macs
    chain = [channels[0]] + list(channels)
    side = size
    for i in range(len(channels)):                    # levels and bottom
        a, b = chain[i], chain[i + 1]
        macs += side * side * b * (a + b) * 9
        if i < len(channels) - 1:
            side //= 2
    rev = list(channels)[::-1]
    for i in range(len(channels) - 1):
        side *= 2
        macs += side * side * (rev[i] // 2) * rev[i] * 4   # up-conv 2x2
        macs += side * side * rev[i + 1] * (rev[i] + rev[i + 1]) * 9
    macs += size * size * channels[0]                 # final 1x1
    return macs, first


def port_leaves(cell):
    from portbench.control import leaves_of
    return {n: s for n, s, d in leaves_of(cell, torch.device("cpu"))
            if d.is_floating_point}


def test_unet_256_macs_by_hand():
    cell = spec.load_cell("unet_256.train_b32")
    assert unet_leaves() == port_leaves(cell)
    assert sum(math.prod(s) for n, s in unet_leaves().items()
               if "running" not in n) == 31080449
    got = flops.forward_macs(spec.load_arch(cell.config),
                             cell.config["tree"], 256, 3, unet_leaves())
    assert got == hand_unet_macs()
    assert round(got[0] / 1e9, 2) == 57.03


def test_swin_unet_224_macs():
    cell = spec.load_cell("swin_unet_224.train_b256")
    leaves = port_leaves(cell)
    assert sum(math.prod(s) for s in leaves.values()) == 27166596
    got = flops.forward_macs(spec.load_arch(cell.config),
                             cell.config["tree"], 224, 3, leaves)
    assert round(got[0] / 1e9, 2) == 6.07
    # by hand: the 14 attention products at N = 49 are 2 N^2 C a window
    attention = sum(2 * c.batch * c.windows * c.tokens ** 2 * c.heads
                    * c.head_dim for c in bounds.attention_calls(
                        1, 224, 4, 96, (3, 6, 12, 24), 7, 3, 2))
    assert attention == 4 * 2 * 2401 * (64 * 96 + 16 * 192 + 4 * 384) \
        + 2 * 2 * 2401 * 768
    assert got[1] == 56 * 56 * 96 * 3 * 16           # PatchEmbed's conv


#: (all multiply-adds, those on the image) of one image at the published
#: widths, as the reference counted them before each architecture had a
#: module of its own: the yardstick may not move with the harness
PINNED_MACS = {"swin_unet_224.train_b256": (6071245824, 14450688),
               "unet_256.train_b32": (57025757184, 113246208)}


@pytest.mark.parametrize("name", sorted(PINNED_MACS))
def test_macs_pinned(name):
    cell = spec.load_cell(name)
    got = flops.forward_macs(spec.load_arch(cell.config),
                             cell.config["tree"], cell.config["image_size"],
                             cell.config["in_channels"], port_leaves(cell))
    assert got == PINNED_MACS[name]


def test_train_and_eval_flops():
    assert flops.train_flops((10, 1)) == 2 * (30 - 1)
    assert flops.eval_flops((10, 1)) == 20


def test_k1_bounds_by_hand():
    calls = bounds.attention_calls(24, 224, 4, 96, (3, 6, 12, 24), 7, 3, 2)
    assert len(calls) == 14 and sum(c.masked for c in calls) == 6
    fwd = bounds.forward_bound_s(calls, "bfloat16")
    bwd = bounds.backward_bound_s(calls, "bfloat16")
    assert round(fwd * 1e3, 3) == 0.126
    assert round(bwd * 1e3, 3) == 0.220
    # level 0, masked: q, k, v, out in bf16, bias and mask in float32
    c = calls[1]
    assert c == bounds.Call(24, 64, 3, 49, 32, True)
    qkv = 24 * 64 * 3 * 49 * 32
    moved = 4 * qkv * 2 + 3 * 49 * 49 * 4 + 64 * 49 * 49 * 4
    assert math.isclose(bounds.forward_bound_s([c], "bfloat16"),
                        moved / 3.35e12)
