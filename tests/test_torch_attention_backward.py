"""The attention backward kernels' arithmetic (``csrc/attention_tile_bwd.cuh``),
modelled in plain torch (``torch_port_helpers.window_attention_backward_model``
and ``image_attention_backward_model``), at ``swin_unet_224``'s attention
shapes (N 49, D 32; 3, 6, 12 and 24 heads; W-MSA and SW-MSA) and on a band
of rows of level 0 (spatial sharding's 28 x 56 of 56, with the last band's
rows of the shift mask), two images each.

* The model holds against the port's plain backward versions
  (``window_attention_backward``, ``image_attention_backward``, the
  kernels' oracles on the card) within a tenth of the card's bars: float32
  1e-4 max and 1e-6 mean; bf16 the mean bar 1e-5, and on the max a tenth
  of the 0.05 bar or, where it is larger, one bf16 rounding step of the
  gradient (a tenth of the bar is under the rounding step of a gradient
  above 0.64, and two float32 sums in another order round some values
  apart).  dbias and dmask, which sum over windows,
  are held relative to their largest magnitude, to the float32 bars in
  both dtypes (dS is float32 in both).
* Both kernels add S + (bias + mask) (one table a block), the JAX package
  (S + bias) + mask; the model follows the kernels, and the two orders
  keep a tenth of the bars apart, under the shift mask and under a dense
  one, in either dtype.  The model sums dbias and dmask over the blocks
  of the kernels' grid (three blocks an SM in bf16, two in float32), and
  over chunks of several images too.
* In float32 it holds against the JAX package's custom VJPs, ``_fused_bwd``
  and ``_fused_image_bwd`` (plain jnp, called straight on the inputs;
  for the band, whose rectangle ``_xla_image_attention`` does not take,
  ``_fused_bwd`` on its windows), dmask included, within JAX_TOL.
* One TF32 pass misses the float32 bars and one bf16 rounding of P and dS
  the bf16 mean bar: the splits are what the bars need, and the bars catch
  a kernel that drops them.

The CPU kernels of the registered backward operators run the plain
versions; their fake implementations give the gradients' shapes.  The
kernels themselves run on the card (``test_torch_kernels_gpu.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.ops import window_attention as jax_wa
from medsegpretrainimagenet_tpu_torch.models.swin import (
    _relative_position_index, _shift_attn_mask)
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

from torch_port_helpers import (BACKWARD_RESIDENT, grid_per,
                                image_attention_backward_model,
                                image_merge, image_windows,
                                window_attention_backward_model)

#: the card's bars: float32 max and mean |kernel - plain|, bf16 max and
#: mean; dbias and dmask relative to their largest magnitude, float32's
F32_TOL, F32_MEAN_TOL, BF16_TOL, BF16_MEAN_TOL = 1e-4, 1e-6, 0.05, 1e-5
#: the margin the model keeps under them
MARGIN = 10
#: model against the JAX package in float32 (it reads about 2e-6; the
#: recompute test of test_torch_window_attention.py holds 2e-4)
JAX_TOL = 2e-5
WINDOW, TOKENS, HEAD_DIM, IMAGES = 7, 49, 32, 2
SCALE = HEAD_DIM ** -0.5

#: (level, heads, rows of the image, shifted); level l is 56 / 2^l pixels
#: square, and "band" is level 0's 28 x 56 band with the last band's mask
#: rows
LEVELS = [(0, 3, 56, False), (0, 3, 56, True), (1, 6, 28, False),
          (1, 6, 28, True), (2, 12, 14, False), (2, 12, 14, True),
          (3, 24, 7, False)]
SHAPES = [pytest.param(*shape, id=f"level{shape[0]}-"
                       f"{'sw_msa' if shape[3] else 'w_msa'}")
          for shape in LEVELS]
BAND = pytest.param(0, 3, 28, True, id="band28x56-sw_msa")
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])
GRADS = ("dq", "dk", "dv", "dbias", "dmask")
IMAGE_GRADS = ("dqkv", "dbias", "dmask")


def _inputs(level, heads, rows, masked, seed=0):
    """float32 numpy arrays: qkv (IMAGES, rows, 56 / 2^level, 3C), g (...,
    C), the relative-position bias of a random table and the shift mask
    (a band's rows: the last ones of the whole image's)."""
    rng = np.random.default_rng(100 * level + 10 * masked + rows)
    cols = 56 // 2 ** level
    c = heads * HEAD_DIM
    qkv = rng.standard_normal((IMAGES, rows, cols, 3 * c)).astype(np.float32)
    g = rng.standard_normal((IMAGES, rows, cols, c)).astype(np.float32)
    table = 0.02 * rng.standard_normal(((2 * WINDOW - 1) ** 2, heads))
    index = _relative_position_index((WINDOW, WINDOW)).reshape(-1)
    bias = np.ascontiguousarray(table[index].reshape(TOKENS, TOKENS, heads)
                                .transpose(2, 0, 1)).astype(np.float32)
    mask = None
    if masked:
        whole = _shift_attn_mask((cols, cols), WINDOW, WINDOW // 2)
        mask = whole[len(whole) - (rows // WINDOW) * (cols // WINDOW):]
        mask = np.ascontiguousarray(mask)
    return qkv, g, bias, mask


def _torch(arrays, dtype=torch.float32):
    """Tensors: the first two (qkv, g) in *dtype*, the tables float32."""
    return [None if a is None else torch.from_numpy(a).to(
        dtype if i < 2 else torch.float32) for i, a in enumerate(arrays)]


def _k1(qkv, g, heads):
    """qkv, g in the image layout -> q, k, v, g in the windows layout."""
    q, k, v = image_windows(qkv, WINDOW, 3, heads)
    return q, k, v, image_windows(g, WINDOW, 1, heads)[0]


def _grads(kernel, how, arrays, dtype, **kw):
    """The named gradients of *kernel* (k1, k2) by *how* (model, plain)."""
    qkv, g, bias, mask = _torch(arrays, dtype)
    heads = bias.shape[0]
    if kernel == "k1":
        q, k, v, gw = _k1(qkv, g, heads)
        fn = window_attention_backward_model if how == "model" \
            else wa.window_attention_backward
        return dict(zip(GRADS, fn(q, k, v, bias, mask, SCALE, gw, **kw)))
    if how == "model":
        out = image_attention_backward_model(qkv, bias, mask, SCALE, WINDOW,
                                             g, **kw)
    else:
        out = wa.image_attention_backward(qkv, bias, mask, SCALE, WINDOW, g)
    return dict(zip(IMAGE_GRADS, out))


def _readings(got: dict, want: dict) -> dict:
    """{name: (max, mean)} of |got - want|; dbias and dmask relative to
    the largest |want|."""
    out = {}
    for name, a in got.items():
        b = want[name]
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        diff = (a.float() - b.float()).abs()
        if name in ("dbias", "dmask"):
            diff = diff / b.float().abs().max()
        out[name] = (diff.max().item(), diff.mean().item())
    return out


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding step (ulp) at each value of the bf16 *x*."""
    x = x.float().abs()
    exponent = torch.floor(torch.log2(torch.clamp(x, min=2.0 ** -126)))
    return torch.pow(2.0, exponent - 7)


def _assert_a_tenth(got: dict, want: dict, dtype) -> None:
    """*got* keeps a tenth of the card's bars from *want*: float32 (and
    dbias and dmask, relative) on the max and the mean; bf16 on the mean,
    and on the max a tenth of the bar or one bf16 step of the gradient."""
    for name, (err, mean_err) in _readings(got, want).items():
        if dtype == torch.float32 or name in ("dbias", "dmask"):
            assert err < F32_TOL / MARGIN, (name, err)
            assert mean_err < F32_MEAN_TOL / MARGIN, (name, mean_err)
            continue
        assert mean_err < BF16_MEAN_TOL / MARGIN, (name, mean_err)
        diff = (got[name].float() - want[name].float()).abs()
        bar = torch.clamp(_bf16_step(want[name]), min=BF16_TOL / MARGIN)
        assert (diff <= bar).all(), (name, err)
        assert err < BF16_TOL


def _grid_per(kernel, dtype, heads, rows, cols, masked) -> int:
    """The images a block of *kernel*'s backward walks at these shapes
    (IMAGES images), as its grid takes them on the card."""
    windows = (rows // WINDOW) * (cols // WINDOW)
    if kernel == "k1":
        n_w = windows if masked else 1
        groups, images = n_w * heads, IMAGES * windows // n_w
    else:
        groups, images = windows * heads, IMAGES
    return grid_per(groups, images, BACKWARD_RESIDENT[dtype])


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@DTYPES
@pytest.mark.parametrize("level,heads,rows,masked", SHAPES + [BAND])
def test_model_keeps_a_tenth_of_the_bars(kernel, dtype, level, heads, rows,
                                         masked):
    arrays = _inputs(level, heads, rows, masked)
    want = _grads(kernel, "plain", arrays, dtype)
    per = _grid_per(kernel, dtype, heads, rows, 56 // 2 ** level, masked)
    got = _grads(kernel, "model", arrays, dtype, per=per)
    assert (got["dmask"] is None) == (not masked)
    _assert_a_tenth(got, want, dtype)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@DTYPES
@pytest.mark.parametrize("level,heads,rows,masked", SHAPES + [BAND])
def test_model_in_chunks_of_images_keeps_a_tenth_of_the_bars(
        kernel, dtype, level, heads, rows, masked):
    """The same with blocks that walk two images each (a grid at a larger
    batch), so that a partial sums several pairs before the partials'
    sum."""
    arrays = _inputs(level, heads, rows, masked)
    want = _grads(kernel, "plain", arrays, dtype)
    got = _grads(kernel, "model", arrays, dtype, per=IMAGES // 2 + 1)
    _assert_a_tenth(got, want, dtype)


def test_grid_per_follows_the_kernels_plan():
    """tile::plan's grid at swin_224_train's shapes (batch 24) on 132 SMs:
    K1's level-1 SW-MSA call (96 groups of 24 images) takes four chunks of
    six images at three blocks an SM, two of twelve at two; its W-MSA call
    (six groups of 384 windows) 66 chunks of six windows at three, 44 of
    nine at two."""
    assert grid_per(96, 24, 3) == 6 and grid_per(96, 24, 2) == 12
    assert grid_per(6, 384, 3) == 6 and grid_per(6, 384, 2) == 9
    assert grid_per(24 * 64, 1, 3) == 1


MASKED_SHAPES = [shape for shape in SHAPES if shape.values[3]] + [BAND]


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("mask_kind,dtype", [
    pytest.param("shift", torch.float32, id="shift"),
    pytest.param("dense", torch.float32, id="dense"),
    pytest.param("shift", torch.bfloat16, id="shift_bf16"),
    pytest.param("dense", torch.bfloat16, id="dense_bf16")])
@pytest.mark.parametrize("level,heads,rows,masked", MASKED_SHAPES)
def test_summed_table_keeps_a_tenth_of_the_bars(kernel, mask_kind, dtype,
                                                level, heads, rows, masked):
    """Both kernels add S + (bias + mask), the table a block sums when it
    loads it, where the JAX package and the plain version take (S + bias) +
    mask.  The model in either order, against the other and against the
    plain version, keeps a tenth of the bars (float32's, or bf16's): under
    Swin's shift mask (0 or -100) and under a dense mask of standard
    normal values, whose sums with the bias round at every entry."""
    qkv, g, bias, mask = _inputs(level, heads, rows, masked, seed=2)
    if mask_kind == "dense":
        rng = np.random.default_rng(7 + level)
        mask = rng.standard_normal(mask.shape).astype(np.float32)
    arrays = (qkv, g, bias, mask)
    want = _grads(kernel, "plain", arrays, dtype)
    summed = _grads(kernel, "model", arrays, dtype, summed=True)
    added = _grads(kernel, "model", arrays, dtype, summed=False)
    for got, ref in ((summed, want), (added, want), (summed, added)):
        _assert_a_tenth(got, ref, dtype)


#: the JAX package's backward functions as they are, each traced once per
#: shape into one program (op by op they take seconds a shape on the CPU)
_FUSED_BWD = jax.jit(jax_wa._fused_bwd, static_argnums=0)
_FUSED_IMAGE_BWD = jax.jit(jax_wa._fused_image_bwd, static_argnums=(0, 1))


def _jax(kernel, arrays):
    """The JAX package's custom VJP on the float32 inputs: _fused_bwd on
    K1's layout; _fused_image_bwd on K2's, or on a band (a rectangle,
    which the XLA image path does not take) _fused_bwd on its windows,
    merged back."""
    qkv, g, bias, mask = arrays
    heads = bias.shape[0]
    b, rows, cols, _ = qkv.shape
    tables = [jnp.asarray(bias), None if mask is None else jnp.asarray(mask)]
    if kernel == "k2" and rows == cols:
        out = _FUSED_IMAGE_BWD(SCALE, WINDOW,
                                      (jnp.asarray(qkv), *tables),
                                      jnp.asarray(g))
        return dict(zip(IMAGE_GRADS, (None if x is None else
                                      torch.from_numpy(np.asarray(x))
                                      for x in out)))
    q, k, v, gw = (jnp.asarray(t.numpy())
                   for t in _k1(torch.from_numpy(qkv), torch.from_numpy(g),
                                heads))
    out = [None if x is None else torch.from_numpy(np.asarray(x))
           for x in _FUSED_BWD(SCALE, (q, k, v, *tables), gw)]
    if kernel == "k1":
        return dict(zip(GRADS, out))
    return dict(zip(IMAGE_GRADS, (image_merge(torch.stack(out[:3]), b, rows,
                                              cols, WINDOW), *out[3:])))


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("level,heads,rows,masked", SHAPES + [BAND])
def test_model_matches_the_jax_custom_vjp(kernel, level, heads, rows,
                                          masked):
    arrays = _inputs(level, heads, rows, masked, seed=1)
    want = _jax(kernel, arrays)
    got = _grads(kernel, "model", arrays, torch.float32)
    assert (want["dmask"] is None) == (not masked)
    for name, (err, _) in _readings(got, want).items():
        assert err < JAX_TOL, (name, err)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@DTYPES
@pytest.mark.parametrize("level,heads,rows,masked", SHAPES)
def test_one_pass_misses_the_bars(kernel, dtype, level, heads, rows,
                                  masked):
    """Without the splits (one TF32 pass in float32, P and dS rounded to
    bf16 once in bf16) the model reads about 1.5e-3 max and 8e-5 mean in
    float32 (dbias 4e-4 of its largest value), about 3e-4 mean in bf16: a
    kernel that drops them fails the bars.  In bf16 that mean is as large
    as a dropped bias's 3e-3 over ten: the bar could not tell the two
    apart."""
    arrays = _inputs(level, heads, rows, masked)
    want = _grads(kernel, "plain", arrays, dtype)
    got = _readings(_grads(kernel, "model", arrays, dtype, split=False),
                    want)
    grads = ("dq", "dk", "dv") if kernel == "k1" else ("dqkv",)
    if dtype == torch.float32:
        assert max(got[n][0] for n in grads) > F32_TOL
        assert min(got[n][1] for n in grads) > F32_MEAN_TOL
        assert got["dbias"][0] > F32_TOL
    else:
        assert min(got[n][1] for n in grads) > BF16_MEAN_TOL


@pytest.mark.parametrize("masked", [False, True], ids=["w_msa", "sw_msa"])
def test_cpu_operators_run_the_plain_backward(masked):
    """The registered backward operators' CPU kernels: the plain versions,
    their gradients listed as [inputs'..., dbias if asked for, dmask if
    asked for and there is a mask]."""
    qkv, g, bias, mask = _torch(_inputs(1, 6, 28, masked))
    q, k, v, gw = _k1(qkv, g, 6)
    plain = wa.window_attention_backward(q, k, v, bias, mask, SCALE, gw)
    image = wa.image_attention_backward(qkv, bias, mask, SCALE, WINDOW, g)
    for bias_grad in (False, True):
        for mask_grad in (False, True):
            listed = [bias_grad, mask_grad and masked]
            got = torch.ops.medseg_torch.window_attention_backward(
                q, k, v, bias, mask, gw, SCALE, bias_grad, mask_grad)
            want = [*plain[:3], *[t for t, on in zip(plain[3:], listed)
                                  if on]]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            got = torch.ops.medseg_torch.image_attention_backward(
                qkv, bias, mask, g, SCALE, WINDOW, bias_grad, mask_grad)
            want = [image[0], *[t for t, on in zip(image[1:], listed) if on]]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def test_fake_backward_operators_give_the_gradients_shapes():
    """What ``torch.export`` traces of a training graph on the card: the
    gradients' shapes and dtypes, dbias and dmask as asked for; a g of
    another shape than the output's is refused by the kernels' checks on
    the card, and a mask of another window count by the fake's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty(32, 3, 49, 32, device="cuda", dtype=torch.bfloat16)
        bias = torch.empty(3, 49, 49, device="cuda")
        mask = torch.empty(16, 49, 49, device="cuda")
        got = torch.ops.medseg_torch.window_attention_backward(
            q, q, q, bias, mask, q, SCALE, True, True)
        assert [tuple(t.shape) for t in got] == [tuple(q.shape)] * 3 + [
            (3, 49, 49), (16, 49, 49)]
        assert [t.dtype for t in got] == [torch.bfloat16] * 3 \
            + [torch.float32] * 2
        got = torch.ops.medseg_torch.window_attention_backward(
            q, q, q, bias, None, q, SCALE, False, True)
        assert len(got) == 3
        qkv = torch.empty(2, 14, 28, 288, device="cuda")
        g = torch.empty(2, 14, 28, 96, device="cuda")
        got = torch.ops.medseg_torch.image_attention_backward(
            qkv, bias, torch.empty(8, 49, 49, device="cuda"), g, SCALE,
            WINDOW, False, True)
        assert [tuple(t.shape) for t in got] == [(2, 14, 28, 288),
                                                (8, 49, 49)]
        with pytest.raises(ValueError, match="mask must be"):
            torch.ops.medseg_torch.image_attention_backward(
                qkv, bias, mask, g, SCALE, WINDOW, True, True)


def test_cpu_tensors_never_reach_the_backward_kernels():
    """On a CPU tensor autograd through the dispatch is the plain version's
    (no backward launch), and the kernels' wrappers refuse it."""
    qkv, g, bias, mask = _torch(_inputs(2, 12, 14, True))
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, mask)]
    wa.window_attention_backward_cuda.launches = 0
    wa.image_attention_backward_cuda.launches = 0
    (wa.fused_image_window_attention(*leaves, SCALE, WINDOW) * g).sum() \
        .backward()
    want = wa.image_attention_backward(qkv, bias, mask, SCALE, WINDOW, g)
    for leaf, ref in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, ref, rtol=2e-5, atol=2e-5)
    assert wa.window_attention_backward_cuda.launches == 0
    assert wa.image_attention_backward_cuda.launches == 0
    q, k, v, gw = _k1(qkv, g, 12)
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_backward_cuda(q, k, v, bias, mask, SCALE, gw)
    with pytest.raises(ValueError, match="CUDA"):
        wa.image_attention_backward_cuda(qkv, bias, mask, SCALE, WINDOW, g)
