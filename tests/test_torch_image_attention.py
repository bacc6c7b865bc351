"""The port's image-layout window attention against the JAX package's: the
plain PyTorch version against the XLA op sequence and the Pallas kernel
(interpret mode), bf16 rounding points, gradients against ``jax.grad``, the
fused-mode switch, CPU dispatch, and a Swin block and the small Swin U-Net
in fused mode with transplanted weights.  The CUDA kernel itself is held
against the plain version on the card in ``test_torch_kernels_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu import ops as jax_ops
from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.models import swin as jax_swin
from medsegpretrainimagenet_tpu.ops import window_attention as jax_wa
from medsegpretrainimagenet_tpu_torch import ops
from medsegpretrainimagenet_tpu_torch.config import ConfigDict, registry
from medsegpretrainimagenet_tpu_torch.models import Model, swin
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

from torch_port_helpers import build_model, model_config, transplant

SCALE = 0.25
MASKED = pytest.mark.parametrize("masked", [False, True],
                                 ids=["w_msa", "sw_msa"])


def _inputs(seed, b=2, r=8, window=4, heads=2, d=8, masked=True):
    """qkv (B, R, R, 3C), bias (H, N, N) and a 0/-100 mask per window."""
    rng = np.random.default_rng(seed)
    n, n_w = window * window, (r // window) ** 2
    qkv = rng.standard_normal((b, r, r, 3 * heads * d)).astype(np.float32)
    bias = rng.standard_normal((heads, n, n)).astype(np.float32)
    mask = np.where(rng.random((n_w, n, n)) > 0.5, -100.0, 0.0) \
        .astype(np.float32) if masked else None
    return qkv, bias, mask


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(
        dtype if i == 0 else torch.float32) for i, a in enumerate(arrays)]


def _jax(arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype if i == 0
                                               else jnp.float32)
            for i, a in enumerate(arrays)]


@pytest.fixture
def fused_on():
    """Both packages' Swin blocks on the image-layout path."""
    jax_ops.set_fused_image_mode("on")
    ops.set_fused_image_mode("on")
    try:
        yield
    finally:
        jax_ops.set_fused_image_mode("off")
        ops.set_fused_image_mode("off")


#: (window, D, R) with N = window^2 at the edges of what the CUDA kernel
#: takes, and swin_unet_224's (7, 32): the plain version, which the card's
#: tests trust as the kernel's oracle, equals the JAX package's at each.
#: The first keeps the ids the test had before it took a shape.
EDGE_SHAPES = [pytest.param(masked, window, d, r,
                            id=("sw_msa" if masked else "w_msa") + suffix)
               for window, d, r, suffix in ((4, 8, 8, ""),
                                            (7, 32, 14, "-49x32"),
                                            (8, 64, 16, "-64x64"))
               for masked in (False, True)]


@pytest.mark.parametrize("masked,window,d,r", EDGE_SHAPES)
def test_plain_matches_xla_image_path(masked, window, d, r):
    arrays = _inputs(0, r=r, window=window, d=d, masked=masked)
    ref = jax_wa._xla_image_attention(*_jax(arrays), SCALE, window)
    out = wa.image_attention_torch(*_torch(arrays), SCALE, window)
    assert out.shape == (2, r, r, 2 * d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@MASKED
def test_plain_matches_pallas_image_kernel_interpret(masked):
    """The TPU kernel, run in Pallas interpret mode on the CPU, is the
    function the CUDA kernel replaces."""
    from jax.experimental.pallas import tpu as pltpu

    arrays = _inputs(1, masked=masked)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_wa._pallas_image_attention(*_jax(arrays), SCALE, 4)
    out = wa.image_attention_torch(*_torch(arrays), SCALE, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_plain_bf16_keeps_the_jax_rounding_points():
    """bf16 in, bf16 out, at the swin_unet_224 window (N = 49, D = 32):
    the two differ only in float32 summation order, so at most one bf16
    rounding step apart."""
    arrays = _inputs(2, b=1, r=14, window=7, heads=3, d=32)
    scale = 32 ** -0.5
    ref = np.asarray(jax_wa._xla_image_attention(
        *_jax(arrays, jnp.bfloat16), scale, 7).astype(jnp.float32))
    out = wa.image_attention_torch(*_torch(arrays, torch.bfloat16), scale, 7)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref,
                               rtol=2 ** -7, atol=1e-3)


@MASKED
def test_grads_match_jax_grad(masked):
    """Autograd through the CPU dispatch and ``image_attention_backward``
    (the kernel's autograd backward) both give jax.grad's dqkv, dbias and,
    with a mask, dmask."""
    arrays = _inputs(3, masked=masked)
    g = np.random.default_rng(4).standard_normal((2, 8, 8, 16)) \
        .astype(np.float32)
    argnums = (0, 1, 2) if masked else (0, 1)

    def loss(*args):
        if not masked:
            args = (*args, None)
        return jnp.sum(jax_wa._xla_image_attention(*args, SCALE, 4) * g)

    ref = jax.grad(loss, argnums=argnums)(*_jax(arrays)[:len(argnums)])
    leaves = [None if t is None else t.requires_grad_()
              for t in _torch(arrays)]
    (ops.fused_image_window_attention(*leaves, SCALE, 4)
     * torch.from_numpy(g)).sum().backward()
    recomputed = wa.image_attention_backward(*_torch(arrays), SCALE, 4,
                                             torch.from_numpy(g))
    assert (recomputed[2] is None) == (not masked)
    for i, want in enumerate(ref):
        for got in (leaves[i].grad, recomputed[i]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=2e-4)


def test_fused_image_dispatch_policy():
    """Off by default; "on" forces the path; "auto" takes it for the
    no-grad bf16 forward on a CUDA tensor only; a bad mode raises."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert ops.use_fused_image(False, torch.bfloat16, cuda) is False
    try:
        ops.set_fused_image_mode("on")
        assert ops.use_fused_image(True, torch.float32, cpu) is True
        ops.set_fused_image_mode("auto")
        with torch.no_grad():
            assert ops.use_fused_image(False, torch.bfloat16, cuda) is True
            assert ops.use_fused_image(False, torch.bfloat16, cpu) is False
            assert ops.use_fused_image(False, torch.float32, cuda) is False
            assert ops.use_fused_image(True, torch.bfloat16, cuda) is False
        assert ops.use_fused_image(False, torch.bfloat16, cuda) is False
    finally:
        ops.set_fused_image_mode("off")
    with pytest.raises(ValueError, match="bogus"):
        ops.set_fused_image_mode("bogus")
    assert ops.use_fused_image(True, torch.float32, cpu) is False


@pytest.mark.parametrize("force", [None, "torch"])
def test_cpu_dispatch_runs_plain_version_and_counts_no_launch(force):
    arrays = _torch(_inputs(6))
    wa.image_attention_cuda.launches = 0
    out = ops.fused_image_window_attention(*arrays, SCALE, 4, force=force)
    np.testing.assert_array_equal(
        out.numpy(), wa.image_attention_torch(*arrays, SCALE, 4).numpy())
    assert wa.image_attention_cuda.launches == 0


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    qkv, bias, mask = _torch(_inputs(7))
    with pytest.raises(ValueError, match="CUDA"):
        wa.image_attention_cuda(qkv, bias, mask, SCALE, 4)
    with pytest.raises(ValueError, match="force"):
        ops.fused_image_window_attention(qkv, bias, mask, SCALE, 4,
                                         force="xla")
    assert wa.image_attention_cuda.launches == 0


#: (B, Rh, Rw) bands of a square image's rows, as spatial sharding cuts
#: them (Rh = Rw / S, window 4): two and four bands of 16 rows, and a band
#: of one window row
RECTANGLES = [pytest.param(2, 8, 16, id="8x16"),
              pytest.param(2, 4, 16, id="4x16"),
              pytest.param(1, 4, 8, id="4x8")]


def _band_inputs(seed, b, rows, cols, window=4, heads=2, d=8):
    """qkv (B, Rh, Rw, 3C), bias and a 0/-100 mask of the band's
    (Rh/w)(Rw/w) windows, as float32 torch tensors."""
    rng = np.random.default_rng(seed)
    n, n_w = window * window, (rows // window) * (cols // window)
    qkv = rng.standard_normal((b, rows, cols, 3 * heads * d))
    bias = rng.standard_normal((heads, n, n))
    mask = np.where(rng.random((n_w, n, n)) > 0.5, -100.0, 0.0)
    return [torch.from_numpy(a.astype(np.float32))
            for a in (qkv, bias, mask)]


def _band_windows(t, window):
    """(B, Rh, Rw, C) -> (B * nW, N, C), windows in row-major order."""
    b, rows, cols, c = t.shape
    return swin.window_partition(t, window).reshape(b * (rows // window)
                                                    * (cols // window),
                                                    window * window, c)


@pytest.mark.parametrize("b,rows,cols", RECTANGLES)
def test_rectangles_equal_the_windows_path(b, rows, cols):
    """The plain image-layout version on a band of rows (B, Rh, Rw, 3C)
    equals K1's plain version on the same windows with the band's mask rows
    (window i * Rw/w + j takes row i * Rw/w + j), forward and backward;
    both are one op sequence in float32, so they agree to rounding
    (1e-6)."""
    window, heads = 4, 2
    qkv, bias, mask = _band_inputs(3, b, rows, cols)
    c = qkv.shape[-1] // 3
    got = wa.image_attention_torch(qkv, bias, mask, SCALE, window)
    assert got.shape == (b, rows, cols, c)
    t = _band_windows(qkv, window).reshape(-1, window * window, 3, heads,
                                           c // heads).permute(2, 0, 3, 1, 4)
    want = wa.window_attention_torch(t[0], t[1], t[2], bias, mask, SCALE)
    want = swin.window_reverse(want.transpose(1, 2).reshape(
        -1, window, window, c), window, rows, cols)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        got.shape).astype(np.float32))
    dqkv, dbias, dmask = wa.image_attention_backward(qkv, bias, mask, SCALE,
                                                     window, g)
    ref = qkv.clone().requires_grad_()
    ref_bias = bias.clone().requires_grad_()
    ref_mask = mask.clone().requires_grad_()
    t = _band_windows(ref, window).reshape(-1, window * window, 3, heads,
                                           c // heads).permute(2, 0, 3, 1, 4)
    out = wa.window_attention_torch(t[0], t[1], t[2], ref_bias, ref_mask,
                                    SCALE)
    out = swin.window_reverse(out.transpose(1, 2).reshape(
        -1, window, window, c), window, rows, cols)
    (out * g).sum().backward()
    for name, value, want in (("dqkv", dqkv, ref.grad),
                              ("dbias", dbias, ref_bias.grad),
                              ("dmask", dmask, ref_mask.grad)):
        np.testing.assert_allclose(value.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("b,rows,cols", RECTANGLES)
def test_fake_operator_gives_the_rectangle(b, rows, cols):
    """The registered operator's fake implementation (what ``torch.export``
    traces) takes a band of rows and gives its (B, Rh, Rw, C); a mask
    with another window count than the band's is refused."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        qkv = torch.empty(b, rows, cols, 48, device="cuda")
        bias = torch.empty(2, 16, 16, device="cuda")
        n_w = (rows // 4) * (cols // 4)
        out = torch.ops.medseg_torch.image_attention(
            qkv, bias, torch.empty(n_w, 16, 16, device="cuda"), SCALE, 4)
        assert tuple(out.shape) == (b, rows, cols, 16)
        with pytest.raises(ValueError, match="mask must be"):
            torch.ops.medseg_torch.image_attention(
                qkv, bias, torch.empty(n_w * 2, 16, 16, device="cuda"),
                SCALE, 4)


def _block_kwargs(position):
    return dict(in_channels=16, img_size=64, patch_size=4, embed_dim=8,
                num_heads_layers=(1, 2, 4), window_size=4, position=position)


@pytest.mark.parametrize("position", [0, 1], ids=["w_msa", "sw_msa"])
def test_swin_block_fused_mode_matches_jax_fused_mode(position, fused_on,
                                                      monkeypatch):
    """The port's block on the image-layout path against the JAX block on
    its own, with transplanted weights: the path shares the windows
    path's parameters, so the same state dict serves both."""
    x = np.random.default_rng(8 + position).standard_normal((2, 64, 16)) \
        .astype(np.float32)
    jax_block = jax_swin.SwinTransformerBlock(**_block_kwargs(position))
    variables = jax_block.init(jax.random.key(0), jnp.asarray(x))
    ref = jax_block.apply(variables, jnp.asarray(x))
    port = transplant(variables, swin.SwinTransformerBlock(
        **_block_kwargs(position)))
    assert set(port.attn.state_dict()) == {
        "qkv.weight", "qkv.bias", "proj.weight", "proj.bias",
        "relative_position_bias_table"}
    calls = []
    fused = swin.fused_image_window_attention
    monkeypatch.setattr(swin, "fused_image_window_attention",
                        lambda *a, **k: calls.append(a[2]) or fused(*a, **k))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert len(calls) == 1 and (calls[0] is None) == (position == 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    ops.set_fused_image_mode("off")
    with torch.no_grad():
        windows_path = port(torch.from_numpy(x))
    assert len(calls) == 1
    np.testing.assert_allclose(out.numpy(), windows_path.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_small_swin_unet_fused_mode_matches_jax_fused_mode(fused_on):
    jax_model = build_model(JaxConfigDict, jax_registry, JaxModel,
                            model_config())
    variables = jax_model.init(jax.random.key(0),
                               {"x": np.zeros((1, 64, 64, 3), np.float32)})
    port = build_model(ConfigDict, registry, Model, model_config())
    transplant(variables, port.module)
    x = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    ref = jax_model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port.apply(torch.from_numpy(x))
    assert out.shape == (2, 64, 64, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)
