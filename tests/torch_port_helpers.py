"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: a small Swin U-Net and a small conv U-Net configuration, built by
either package, weight transplanting from a flax module into its torch
counterpart, and a small IDRiD tree."""
import contextlib
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import torch
from PIL import Image

from medsegpretrainimagenet_tpu_torch import transfer
from medsegpretrainimagenet_tpu_torch.transfer import state_dict_from_jax


def swin_unet_architecture(img=64, embed=8, channels=(8, 16, 32),
                           heads=(1, 2, 4), window=4):
    """The ``architecture`` section of a small Swin U-Net config (the
    shape of ``config/downstream/covidqu/swin_unet.yaml``, cut to size)."""
    return {
        "in_channel_size": 3, "out_channel_size": 1,
        "depth": len(channels) - 1, "width": 2, "channels": tuple(channels),
        "change_channels_in_block": False, "trainable_downsampling": True,
        "stochastic depth rate": 0.2,
        "basic_block": {"segmentation.models.blocks.SwinTransformerBlock": {
            "img_size": img, "patch_size": 4, "embed_dim": embed,
            "num_heads_layers": tuple(heads), "window_size": window}},
        "mixing_block": {"segmentation.models.blocks.ConcatLinearBlock": {
            "halve_channels": True, "pass_all_input": True}},
        "stem": {"segmentation.models.blocks.PatchEmbed": {"patch_size": 4}},
        "downsampling": {"segmentation.models.blocks.PatchMerging": {}},
        "upsampling": {"segmentation.models.blocks.PatchExpand": {
            "dim_scale": 2}},
        "final_block": {"segmentation.models.blocks.FinalPatchExpand_X4": {
            "dim_scale": 4}},
        "activation function": {"final": "sigmoid"},
    }


def model_config(**kwargs):
    """A whole ``model`` config section, as a plain dict."""
    return {"model": {"segmentation.models.UNet": {
        "architecture": swin_unet_architecture(**kwargs)}}}


def unet_config(channels=(4, 8, 16), in_channels=3, **architecture):
    """A whole ``model`` config section of the default conv U-Net
    (ConvBlock, BatchNorm, max pooling, UpConvBlock, concatenation), as a
    plain dict; ``depth`` follows the channel ladder."""
    arch = {"in_channel_size": in_channels, "out_channel_size": 1,
            "depth": len(channels) - 1, "channels": tuple(channels)}
    arch.update(architecture)
    return {"model": {"segmentation.models.UNet": {"architecture": arch}}}


def attention_unet_config(channel_sizes=(8, 16), widths=(1, 1), base=4,
                          decoder=(8, 4, 4), in_channels=3, mixing=None):
    """A whole ``model`` config section of the ResNet attention U-Net (the
    shape of ``config/downstream/*/resnet50_attention_unet.yaml``, cut to
    size as ``tests/test_model_families_e2e.py`` cuts it): a ``DeepResNet``
    v1 bottleneck encoder, ``AttentionBlock`` mixing and one decoder level
    more than the encoder has, which undoes the stem's /2."""
    return {"model": {"segmentation.models.UNet": {"architecture": {
        "activation_function": {"final": "sigmoid"},
        "encoder": {"classification.models.DeepResNet": {
            "version": "v1", "bottleneck": True,
            "channel_sizes": tuple(channel_sizes), "widths": tuple(widths),
            "in_channels": in_channels, "base_channel_size": base}},
        "mixing_block": mixing or {
            "segmentation.models.blocks.AttentionBlock": {}},
        "out_channel_size": 1, "decoder_channels": tuple(decoder)}}}}


#: the IDRiD tree's image size and its tasks' mask directories
IDRID_SIZE = (64, 224)
IDRID_TASK_DIRS = {"MA": "1. Microaneurysms", "HE": "2. Haemorrhages",
                   "EX": "3. Hard Exudates", "SE": "4. Soft Exudates",
                   "OD": "5. Optic Disc"}


def _idrid_mask_image(mask: np.ndarray, mode: str) -> Image.Image:
    """A 0/255 mask as a gray, RGB (lesion in red), RGBA or palette
    image."""
    if mode == "L":
        return Image.fromarray(mask)
    if mode == "P":
        image = Image.fromarray((mask > 0).astype(np.uint8), mode="P")
        image.putpalette([0, 0, 0, 255, 0, 0])
        return image
    rgb = np.zeros(mask.shape + (len(mode),), np.uint8)
    rgb[..., 0] = mask
    if mode == "RGBA":
        rgb[..., 3] = 255
    return Image.fromarray(rgb, mode=mode)


def write_idrid_tree(root, n_train=6, n_test=3, tasks=("MA", "HE"),
                     seed=0):
    """The real layout under *root*/idrid: ``IDRiD_NN.jpg`` fundus images
    (a noisy bright field on a black rim, wider at the bottom, so that
    crops there are darker; the reader's 96-px border crop keeps the
    middle 32 columns) and one ``.tif`` mask per task and image; the HE
    masks only for odd ids (the even ones are HE negatives), the EX, SE
    and OD masks written as RGB, RGBA and palette images."""
    rng = np.random.default_rng(seed)
    base = root / "idrid" / "Segmentation" / "A. Segmentation"
    imgs = base / "1. Original Images"
    masks = base / "2. All Segmentation Groundtruths"
    modes = {"MA": "L", "HE": "L", "EX": "RGB", "SE": "RGBA", "OD": "P"}
    idx = 1
    for part, n in (("a. Training Set", n_train), ("b. Testing Set", n_test)):
        (imgs / part).mkdir(parents=True)
        for task in tasks:
            (masks / part / IDRID_TASK_DIRS[task]).mkdir(parents=True)
        for _ in range(n):
            arr = np.zeros(IDRID_SIZE + (3,), np.uint8)
            arr[8:-20, 16:-16] = rng.integers(
                100, 255, (IDRID_SIZE[0] - 28, IDRID_SIZE[1] - 32, 3))
            Image.fromarray(arr).save(imgs / part / f"IDRiD_{idx:02d}.jpg")
            for k, task in enumerate(tasks):
                if task == "HE" and idx % 2 == 0:
                    continue
                m = np.zeros(IDRID_SIZE, np.uint8)
                r = rng.integers(4, IDRID_SIZE[0] - 16)
                c = rng.integers(100, 110)
                m[r:r + 10, c + 2 * k:c + 2 * k + 20] = 255
                _idrid_mask_image(m, modes[task]).save(
                    masks / part / IDRID_TASK_DIRS[task]
                    / f"IDRiD_{idx:02d}_{task}.tif")
            idx += 1


@contextlib.contextmanager
def torch_switches_kept():
    """Restore the process-wide switches that the experiment CLI sets from
    ``meta/technical`` (CPU threads, deterministic algorithms) when the
    block ends: a CLI run in a test process must not change the arithmetic
    of the tests that run after it there (the thread count changes the
    order of the CPU's float32 sums)."""
    saved = (torch.get_num_threads(),
             torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic)
    try:
        yield
    finally:
        torch.set_num_threads(saved[0])
        torch.use_deterministic_algorithms(saved[1])
        torch.backends.cudnn.deterministic = saved[2]


def build_model(package_config, registry, model_cls, cfg):
    """Build the ``Model`` wrapper of either package from a plain config."""
    cd = package_config(cfg)
    cd.expand()
    registry.fill_spec(cd, "model")
    return registry.build(cd, key="model", wrapper=model_cls)


def transplant(variables, module: torch.nn.Module) -> torch.nn.Module:
    """Load flax *variables* into the torch *module* and return it."""
    host = jax.tree_util.tree_map(np.asarray, variables)
    module.load_state_dict(state_dict_from_jax(host, module))
    return module.eval()


def relative_error(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def hold_model(jax_model, variables, port_module, x, cotangent, train,
               dtype, skip=lambda name: False):
    """The forward and the backward of one model in both packages from the
    same *variables*, in *dtype* ("float32", or "float64" with JAX's x64
    switched on and the port's module in double): the output, the pull-back
    of *cotangent* (numpy, the output's shape) onto every parameter through
    ``jax.vjp`` and autograd, and in train mode the updated running
    statistics.  Returns {name: relative error} (parameters not *skip*ped,
    "output", and the statistics), with the port's module left in
    *dtype*."""
    mutable = ["batch_stats"] if train and "batch_stats" in variables \
        else False
    wide = dtype == "float64"
    with jax.enable_x64(wide):
        cast = jax.tree_util.tree_map(
            lambda a: jax.numpy.asarray(np.asarray(a), dtype), variables)

        def forward(params):
            out = jax_model.apply({**cast, "params": params},
                                  jax.numpy.asarray(x, dtype), train=train,
                                  mutable=mutable)
            return out if mutable else (out, {})
        want, pull, updated = jax.vjp(forward, cast["params"], has_aux=True)
        (grads,) = pull(jax.numpy.asarray(cotangent, dtype))
        want, grads, updated = jax.tree_util.tree_map(
            np.asarray, (want, grads, dict(updated)))
    port_module.train(train)
    if wide:
        port_module.double()
    port_module.zero_grad(set_to_none=True)
    out = port_module(torch.from_numpy(np.asarray(x, dtype)))
    out.backward(torch.from_numpy(np.asarray(cotangent, dtype)))
    want_grads = port_named(grads)
    errors = {"output": relative_error(out.detach().numpy(), want)}
    for name, p in port_module.named_parameters():
        if not skip(name):
            errors[name] = relative_error(p.grad.numpy(), want_grads[name])
    if updated:
        want_stats = port_named(updated["batch_stats"], stats=True)
        for name, value in port_module.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                errors[name] = relative_error(value.numpy(),
                                              want_stats[name])
    return errors


def port_named(tree, stats: bool = False):
    """A flax tree of parameters (or, with *stats*, of ``batch_stats``) as
    {the port's name: numpy array in the port's layout}, in the tree's own
    dtype (``state_dict_from_jax`` makes float32 tensors)."""
    out = {}
    for path, value in transfer._leaves(tree):
        value = np.asarray(value)
        if path[-1] == "kernel":
            value = value.T if value.ndim == 2 \
                else value.transpose(3, 2, 0, 1)
        out[transfer._torch_name(path, stats=stats)] = value
    return out


def reference_state(state, family: str, version: str = "v1"):
    """A port encoder state dict under the reference's torch module names
    (the inverse of ``train.torch_mapping``), prefixed ``layers.0.`` as a
    released pretraining checkpoint holds them.  *family*: "unet", "swin"
    or "resnet" (of *version*).  The Swin family also gets the reference's
    buffers, which the translation drops: ``attn.relative_position_index``
    in every block and ``attn_mask`` in each shifted one."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if family == "resnet":
            if parts[0] == "stem_conv":
                key = ("stem.0." if version == "v1" else "stem.") + parts[1]
            elif parts[0] == "stem_bn":
                key = "stem.1." + parts[1]
            else:
                kind, k = parts[3].split("_")
                key = (f"levels.{parts[1]}.{parts[2]}."
                       f"{'conv' if kind == 'Conv' else 'bn'}{int(k) + 1}."
                       f"{parts[4]}")
        elif parts[0] == "stem_block":
            child = {"Conv_0": "proj", "LayerNorm_0": "norm_layer"}[parts[1]]
            key = f"first_block.{parts[-1]}" if family == "unet" \
                else f"first_block.{child}.{parts[2]}"
        elif parts[0] == "downsamples":
            child = {"Dense_0": "reduction", "LayerNorm_0": "norm"}[parts[2]]
            key = f"down_layers.{parts[1]}.downsampl.{child}.{parts[3]}"
        else:
            if parts[0] == "level_convs":
                module, rest = f"down_layers.{parts[1]}.conv{parts[2]}", \
                    parts[3:]
            else:
                module, rest = f"bottom_block.conv{parts[1]}", parts[2:]
            if family == "unet":
                kind, k = rest[0].split("_")
                rest = ["block", str(3 * int(k) + (kind != "Conv")), rest[1]]
            elif rest[0] == "mlp":
                rest = ["mlp", {"Dense_0": "fc1", "Dense_1": "fc2"}[rest[1]],
                        rest[2]]
            key = f"{module}.{'.'.join(rest)}"
            if family == "swin" and rest[-1] == "relative_position_bias_table":
                tokens = int(round(np.sqrt(value.shape[0]))) // 2 + 1
                out[f"layers.0.{module}.attn.relative_position_index"] = \
                    torch.arange(tokens ** 4).reshape(tokens ** 2, tokens ** 2)
                if module[-1] in "13579":
                    out[f"layers.0.{module}.attn_mask"] = torch.zeros(
                        4, tokens ** 2, tokens ** 2)
        out[f"layers.0.{key}"] = value
    return out


# ---------------------------------------------------------------------------
# A plain-torch model of the float32 attention kernels' arithmetic
# (csrc/attention_tile.cuh): split-TF32 tensor-core products
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 *x* rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as ``cvt.rna.tf32.f32`` rounds, by bit arithmetic: add half
    of the dropped 13 bits' unit to the magnitude, then clear them (the sign
    bit stays where it is)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = x in TF32, lo = (x - hi) in TF32, so x = hi + lo to
    about 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor,
                passes: int = 3) -> torch.Tensor:
    """a @ b as the kernel's tensor cores take float32 operands: each split
    into TF32 hi and lo, and lo.hi + hi.lo + hi.hi summed in float32
    (*passes* = 3, the kernel); or one TF32 pass, hi.hi (*passes* = 1, a
    kernel that drops the lo terms).  The product of two TF32 values is
    exact in float32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def window_attention_tf32(q, k, v, bias, mask, scale: float,
                          passes: int = 3) -> torch.Tensor:
    """The float32 window-attention kernel's arithmetic on (B_, H, N, D)
    operands: q * scale in float32, S = q.k^T in split TF32, + bias (+ the
    mask of window b mod nW) in float32, the softmax as e = exp(S - row max)
    times the rounded 1 / sum(e), O = P.v in split TF32."""
    qs = q.float() * float(torch.tensor(scale, dtype=torch.float32))
    logits = tf32_matmul(qs, k.float().transpose(-1, -2), passes) \
        + bias[None].float()
    if mask is not None:
        n_w = mask.shape[0]
        b_, h, n, _ = logits.shape
        logits = (logits.reshape(b_ // n_w, n_w, h, n, n)
                  + mask[None, :, None].float()).reshape(b_, h, n, n)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e * (1.0 / e.sum(-1, keepdim=True))
    return tf32_matmul(probs, v.float(), passes)


def image_attention_tf32(qkv, bias, mask, scale: float, window: int,
                         passes: int = 3) -> torch.Tensor:
    """The float32 image-layout kernel's arithmetic: qkv (B, R, R, 3C) ->
    (B, R, R, C) through :func:`window_attention_tf32` on its windows, in
    the layout of the plain ``image_attention_torch``."""
    b, r, _, c3 = qkv.shape
    c, heads, n_wc = c3 // 3, bias.shape[0], r // window
    t = qkv.reshape(b, n_wc, window, n_wc, window, c3)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, 3, heads,
                                            c // heads)
    t = t.permute(2, 0, 3, 1, 4)
    out = window_attention_tf32(t[0], t[1], t[2], bias, mask, scale, passes)
    out = out.transpose(1, 2).reshape(b, n_wc, n_wc, window, window, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, r, r, c)


# ---------------------------------------------------------------------------
# A plain-torch model of the attention backward kernels' arithmetic
# (csrc/attention_tile_bwd.cuh)
# ---------------------------------------------------------------------------

def _bf16_scale(scale: float) -> float:
    """*scale* rounded to bf16, as the kernels round it for q * scale."""
    return torch.tensor(scale, dtype=torch.float32).bfloat16().item()


def _product(a, b, bf16: bool, split: bool):
    """a @ b of two inputs (or their gradient g) as the kernels' tensor
    cores take them: bf16 operands, whose products are exact, summed in
    float32; or float32 in split TF32 (one TF32 pass without *split*)."""
    return a.float() @ b.float() if bf16 \
        else tf32_matmul(a, b, 3 if split else 1)


def _float_product(x, b, bf16: bool, split: bool):
    """x @ b for x = P or dS (float32): in bf16 x as two bf16 operands, hi
    = bf16(x) and lo = bf16(x - hi), lo.b + hi.b (hi.b alone without
    *split*: P and dS rounded to bf16 once); in float32 split TF32."""
    if not bf16:
        return tf32_matmul(x, b, 3 if split else 1)
    hi = x.bfloat16().float()
    out = hi @ b.float()
    return (x - hi).bfloat16().float() @ b.float() + out if split else out


def summed_partials(ds, n_w: int, heads: int, per: int):
    """dbias and dmask from dS (B_, H, N, N) as the kernels sum them: the
    block of (window w mod n_w, head h) walking images c*per .. c*per +
    per - 1 adds their dS in order into its partial; then dbias[h] sums the
    partials over chunks c, then windows w, dmask[w] over chunks, then
    heads."""
    b_, h, n, _ = ds.shape
    images = b_ // n_w
    chunks = -(-images // per)
    padded = torch.zeros(chunks * per, n_w, heads, n, n)
    padded[:images] = ds.reshape(images, n_w, heads, n, n)
    padded = padded.reshape(chunks, per, n_w, heads, n, n)
    partial = torch.zeros(chunks, n_w, heads, n, n)
    for i in range(per):
        partial += padded[:, i]
    dbias = torch.zeros(heads, n, n)
    dmask = torch.zeros(n_w, n, n)
    for c in range(chunks):
        for w in range(n_w):
            dbias += partial[c, w]
    for c in range(chunks):
        for hh in range(heads):
            dmask += partial[c, :, hh]
    return dbias, dmask


#: the H100's SMs, and the blocks of each backward kernel an SM holds at N
#: 49, D 32 (bf16: three; float32: two; PERF.md)
SMS = 132
BACKWARD_RESIDENT = {torch.bfloat16: 3, torch.float32: 2}
#: log2(e) in float32, by which the bf16 kernel's softmax scales S - max
LOG2E = float(np.float32(1.4426950408889634))


def grid_per(groups: int, images: int, resident: int, sms: int = SMS):
    """The images a block of a backward kernel walks, as ``tile::plan``
    sizes its grid for *groups* groups of *images* pairs: as many blocks as
    fit on the card at once (*resident* an SM), at least one a group."""
    chunks = max(1, min(images, sms * resident // groups))
    return -(-images // chunks)


def window_attention_backward_model(q, k, v, bias, mask, scale: float, g,
                                    split: bool = True, n_w=None,
                                    per: int = 1, summed=None):
    """The backward kernels' arithmetic on (B_, H, N, D) operands of their
    dtype: S = (q * scale) . k^T as the forward takes it (bf16: q * scale
    rounded to bf16, the scale rounded first; float32: split TF32), + the
    bias and mask as S + (bias + mask), the one table each kernel sums
    when its block loads it (``summed=False`` takes (S + bias) + mask, as
    the JAX package adds them); the softmax as e * the rounded 1 / sum(e),
    e = exp(S - max) in float32 and in bf16 2^((S - max) * log2 e) (the bf16
    kernel's ex2); dP = g . v^T; dS = P (dP - rowsum(dP P)) in float32; dV
    = P^T . g, dQ = scale dS . k, dK = scale dS^T . q with P and dS split
    into two bf16 operands in bf16 and everything in split TF32 in float32
    (without *split*: P and dS rounded to bf16 once, or one TF32 pass);
    dbias and dmask from :func:`summed_partials` over groups of *n_w*
    windows (the mask's rows, or 1 without a mask, as K1's grid; K2's grid
    always takes the image's windows) and chunks of *per* images (the
    grid's: :func:`grid_per`).  Returns (dq, dk, dv, dbias, dmask) in the
    inputs' dtype (dbias and dmask float32)."""
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        qs = (q * _bf16_scale(scale)).float()
    else:
        qs = q.float() * float(torch.tensor(scale, dtype=torch.float32))
    logits = _product(qs, k.transpose(-1, -2), bf16, split)
    b_, h, n, _ = logits.shape
    summed = True if summed is None else summed
    if mask is None:
        logits = logits + bias[None].float()
    else:
        rows = mask.shape[0]
        logits = logits.reshape(b_ // rows, rows, h, n, n)
        if summed:
            logits = logits + (bias[None, None].float()
                               + mask[None, :, None].float())
        else:
            logits = (logits + bias[None, None].float()) \
                + mask[None, :, None].float()
        logits = logits.reshape(b_, h, n, n)
    shifted = logits - logits.amax(-1, keepdim=True)
    e = torch.exp2(shifted * LOG2E) if bf16 else torch.exp(shifted)
    probs = e * (1.0 / e.sum(-1, keepdim=True))
    dprobs = _product(g, v.transpose(-1, -2), bf16, split)
    ds = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    scale32 = float(torch.tensor(scale, dtype=torch.float32))
    dv = _float_product(probs.transpose(-1, -2), g, bf16, split)
    dq = scale32 * _float_product(ds, k, bf16, split)
    dk = scale32 * _float_product(ds.transpose(-1, -2), q, bf16, split)
    if n_w is None:
        n_w = 1 if mask is None else mask.shape[0]
    dbias, dmask = summed_partials(ds, n_w, h, per)
    return (dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), dbias,
            None if mask is None else dmask)


def image_windows(x, window: int, parts: int, heads: int):
    """(B, Rh, Rw, parts * C) -> (parts, B_, H, N, D): window partition and
    head split of each of *parts* channel blocks."""
    b, rows, cols, c = x.shape
    t = x.reshape(b, rows // window, window, cols // window, window, c)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, parts,
                                            heads, c // parts // heads)
    return t.permute(2, 0, 3, 1, 4)


def image_merge(t, b: int, rows: int, cols: int, window: int):
    """(parts, B_, H, N, D) -> (B, Rh, Rw, parts * C): the inverse of
    :func:`image_windows`."""
    parts, _, heads, n, d = t.shape
    t = t.permute(1, 3, 0, 2, 4).reshape(b, rows // window, cols // window,
                                         window, window, parts * heads * d)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, rows, cols,
                                               parts * heads * d)


def image_attention_backward_model(qkv, bias, mask, scale: float,
                                   window: int, g, split: bool = True,
                                   per: int = 1, summed=None):
    """The image-layout backward kernel's arithmetic: qkv (B, Rh, Rw, 3C),
    g (B, Rh, Rw, C) -> (dqkv, dbias, dmask), through
    :func:`window_attention_backward_model` on the windows with K2's grid
    (a block per window of the image and head)."""
    b, rows, cols, _ = qkv.shape
    heads = bias.shape[0]
    t = image_windows(qkv, window, 3, heads)
    gw = image_windows(g, window, 1, heads)[0]
    n_w = (rows // window) * (cols // window)
    dq, dk, dv, dbias, dmask = window_attention_backward_model(
        t[0], t[1], t[2], bias, mask, scale, gw, split, n_w=n_w, per=per,
        summed=summed)
    dqkv = image_merge(torch.stack([dq, dk, dv]), b, rows, cols, window)
    return dqkv, dbias, dmask


WORKER = pathlib.Path(__file__).with_name("torch_dp_worker.py")


def spawn_ranks(mode, world, tmp_path, out_names, *args, timeout=120):
    """Run *world* ranks of ``tests/torch_dp_worker.py`` in *mode* to
    their end (each a process of its own, one thread, gloo through a
    ``file://`` rendezvous under *tmp_path*); each writes its result to
    ``tmp_path / out_names[rank]``.  Returns the ranks' outputs."""
    init = tmp_path / "rendezvous"
    env = dict(os.environ, PYTHONPATH=str(WORKER.parent.parent) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(r), str(world), str(init),
         str(tmp_path / out_names[r]), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return outputs


def write_cli_tree(root, arch, n_train=13, n_test=4, size=20, seed=0,
                   init_size=16):
    """A COVID-QU tree under ``root / "data"`` (*n_train* training and
    *n_test* test images of *size* x *size*, a bright square and its mask)
    and one U-Net of *arch* (initialised at *init_size*) as a JAX msgpack
    checkpoint and its ``.pt`` translation.  Returns (data dir, JAX
    weights, port weights)."""
    rng = np.random.default_rng(seed)
    base = root / "data" / "COVID_QU" / "Inf_segm" / "data arrays" \
        / "COVID-19"
    for part, n in (("train and val", n_train), ("test", n_test)):
        d = base / part
        d.mkdir(parents=True)
        images = (rng.random((n, 1, size, size)) * 120).astype(np.uint8)
        masks = np.zeros((n, 1, size, size), np.uint8)
        for i in range(n):
            r, c = rng.integers(2, size - 10, 2)
            images[i, :, r:r + 8, c:c + 8] += 120
            masks[i, :, r:r + 8, c:c + 8] = 2
        np.save(d / "imgs.npy", images)
        np.save(d / "inf_masks.npy", masks)
    cfg = {"model": {"segmentation.models.UNet": {"architecture": arch}}}
    return (root / "data",) + write_weights(root, cfg, init_size,
                                            arch["in_channel_size"])


def write_weights(root, cfg, size, channels):
    """The JAX package's initial weights of the ``model`` config *cfg* (at
    *size* x *size* x *channels*) as a msgpack checkpoint under *root* and
    their ``.pt`` translation.  Returns (JAX weights, port weights)."""
    from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfig
    from medsegpretrainimagenet_tpu.config import registry as jax_registry
    from medsegpretrainimagenet_tpu.models import Model as JaxModel
    from medsegpretrainimagenet_tpu.train import checkpoint as jax_ckpt
    from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.train import checkpoint as ckpt

    jmodel = build_model(JaxConfig, jax_registry, JaxModel, cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), {"x": np.zeros((1, size, size, channels),
                                          np.float32)}))
    jax_weights, port_weights = root / "weights.msgpack", root / "weights.pt"
    jax_ckpt.save_params_file(str(jax_weights), variables)
    module = build_model(ConfigDict, registry, Model, cfg).module
    ckpt.save_params_file(str(port_weights),
                          state_dict_from_jax(variables, module))
    return jax_weights, port_weights


def parallel_cli_config(logs, weights, arch, epochs=2, batch_size=4,
                        max_bs=4, **technical):
    """A tiny COVID-QU CLI config (a U-Net of *arch* at 16 x 16, Dice loss,
    SGD with momentum at a constant rate, DiceIndex and AUROC) for the
    multi-process CLI tests; *technical* adds to ``meta/technical``."""
    return {
        "experiment": {"number_of_epochs": epochs, "number_of_trials": 1},
        "meta": {"technical": {"seed": 777, "save_destination": str(logs),
                               "export_plots_as": ["json"],
                               "maximum_actual_batch_size": max_bs,
                               "number_of_cpu_threads": 1, **technical}},
        "data": {"data": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": 16,
            "validate_on_test": True, "seed": 20231027}},
            "sampling": {"batch_size": batch_size},
            "transforms": {"train": "transform.RepeatChannels",
                           "val": "transform.RepeatChannels",
                           "casting": {"mask": "torch.LongTensor"}}},
        "model": {"segmentation.models.UNet": {
            "architecture": dict(arch), "final_activation": "sigmoid",
            "weight_init": {"weights": str(weights)}}},
        "training": {
            "loss": {"segmentation.losses.DiceLoss": {}},
            "optimizer": {"sgd": {"momentum": 0.9, "learning_rate": {
                "constant": {"base": 0.05}}}}},
        "metrics": {"metrics": ("metrics.DiceIndex", "metrics.AUROC")},
    }


def cli_run_dir(logs):
    """``logs/<date>/Experiment/run_1`` of a finished CLI run."""
    (day,) = [d for d in logs.iterdir() if d.is_dir()]
    return day / "Experiment" / "run_1"


def csv_rows(path):
    import csv
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def run_jax_cli(path, data_dir, *modifiers):
    """The JAX package's CLI on the config at *path*, in this process."""
    from medsegpretrainimagenet_tpu.cli.experiment import main as jax_main
    saved = os.environ.get("MST_DATA_DIR")
    os.environ["MST_DATA_DIR"] = str(data_dir)
    try:
        with torch_switches_kept():
            jax_main([str(path), *modifiers])
    finally:
        if saved is None:
            os.environ.pop("MST_DATA_DIR")
        else:
            os.environ["MST_DATA_DIR"] = saved


def spawn_cli(world, tmp_path, path, logs, data_dir, *modifiers):
    """The port's CLI on the config at *path* under *world* gloo ranks
    (``tests/torch_dp_worker.py cli``).  Returns the ranks' outputs."""
    saved = os.environ.get("MST_DATA_DIR")
    os.environ["MST_DATA_DIR"] = str(data_dir)
    try:
        return spawn_ranks("cli", world, tmp_path,
                           [f"cli{r}.txt" for r in range(world)], path,
                           logs, *modifiers)
    finally:
        if saved is None:
            os.environ.pop("MST_DATA_DIR")
        else:
            os.environ["MST_DATA_DIR"] = saved


def assert_same_logs(got_dir, want_dir, tol, name="epoch_logs.csv"):
    """Every value of *name* in *got_dir* within *tol* of *want_dir*'s."""
    got, want = csv_rows(got_dir / name), csv_rows(want_dir / name)
    assert len(got) == len(want) > 0, (len(got), len(want))
    assert set(got[0]) == set(want[0]), (set(got[0]) ^ set(want[0]))
    for k, (g, w) in enumerate(zip(got, want)):
        for key in w:
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{name} row {k} {key}")
