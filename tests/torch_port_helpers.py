"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: a small Swin U-Net and a small conv U-Net configuration, built by
either package, weight transplanting from a flax module into its torch
counterpart, and a small IDRiD tree."""
import contextlib

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
