"""The float32 attention kernels' split-TF32 arithmetic, modelled in plain
torch (``torch_port_helpers.window_attention_tf32`` and
``image_attention_tf32``), at the attention shapes of the transferability
sweep's Swin encoder at 224 (one probe: a level's windows, W-MSA and
SW-MSA).  The model holds against the port's plain versions within a tenth
of the float32 bars that the card's checks hold the kernels to (1e-4 max,
1e-6 mean), and against the JAX package's XLA path and its Pallas kernels
(interpret mode) within 1e-5.  A single TF32 pass, which drops the lo
terms, misses both bars: the split is what the bars need, and the bars
catch a kernel that drops it.  The kernels themselves run on the card
(``test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.ops import window_attention as jax_wa
from medsegpretrainimagenet_tpu_torch.models.swin import (
    _relative_position_index, _shift_attn_mask)
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

from torch_port_helpers import (image_attention_tf32, split_tf32,
                                tf32_round, window_attention_tf32)

#: the float32 bars of the card's kernel checks
MAX_TOL, MEAN_TOL = 1e-4, 1e-6
#: the margin the model keeps under them
MARGIN = 10
#: model against the JAX package
JAX_TOL = 1e-5
WINDOW, TOKENS, HEAD_DIM = 7, 49, 32
SCALE = HEAD_DIM ** -0.5

#: the Swin encoder's attention calls at 224: (level, heads, windows per
#: image, shifted); the bottom level's one window has no shift
SHAPES = [pytest.param(level, heads, n_w, masked,
                       id=f"level{level}-{'sw_msa' if masked else 'w_msa'}")
          for level, heads, n_w, masked in (
              (0, 3, 64, False), (0, 3, 64, True), (1, 6, 16, False),
              (1, 6, 16, True), (2, 12, 4, False), (2, 12, 4, True),
              (3, 24, 1, False))]
KERNELS = pytest.mark.parametrize("kernel", ["k1", "k2"])


def _inputs(kernel, level, heads, n_w, masked):
    """One probe's operands of a level, from a seeded numpy generator:
    q, k, v (K1) or qkv (K2), the relative-position bias of a random table
    and the level's shift mask."""
    rng = np.random.default_rng(10 * level + masked)
    res = 56 // 2 ** level
    if kernel == "k1":
        operands = [rng.standard_normal((n_w, heads, TOKENS, HEAD_DIM))
                    .astype(np.float32) for _ in range(3)]
    else:
        operands = [rng.standard_normal((1, res, res, 3 * heads * HEAD_DIM))
                    .astype(np.float32)]
    table = 0.02 * rng.standard_normal(((2 * WINDOW - 1) ** 2, heads))
    index = _relative_position_index((WINDOW, WINDOW)).reshape(-1)
    bias = np.ascontiguousarray(table[index].reshape(TOKENS, TOKENS, heads)
                                .transpose(2, 0, 1)).astype(np.float32)
    mask = _shift_attn_mask((res, res), WINDOW, WINDOW // 2) if masked \
        else None
    return operands, bias, mask


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _model(kernel, operands, bias, mask, passes=3):
    if kernel == "k1":
        return window_attention_tf32(*_torch(operands), *_torch([bias, mask]),
                                     SCALE, passes)
    return image_attention_tf32(*_torch([*operands, bias, mask]), SCALE,
                                WINDOW, passes)


def _plain(kernel, operands, bias, mask):
    if kernel == "k1":
        return wa.window_attention_torch(*_torch([*operands, bias, mask]),
                                         SCALE)
    return wa.image_attention_torch(*_torch([*operands, bias, mask]), SCALE,
                                    WINDOW)


def _jax(kernel, operands, bias, mask, pallas):
    args = [None if a is None else jnp.asarray(a)
            for a in (*operands, bias, mask)]
    if not pallas:
        out = jax_wa._xla_window_attention(*args, SCALE) if kernel == "k1" \
            else jax_wa._xla_image_attention(*args, SCALE, WINDOW)
        return np.asarray(out)
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out = jax_wa.window_attention_core(*args, SCALE, force="pallas") \
            if kernel == "k1" \
            else jax_wa._pallas_image_attention(*args, SCALE, WINDOW)
        return np.asarray(out)


@KERNELS
@pytest.mark.parametrize("level,heads,n_w,masked", SHAPES)
def test_split_model_keeps_a_tenth_of_the_f32_bars(kernel, level, heads,
                                                   n_w, masked):
    inputs = _inputs(kernel, level, heads, n_w, masked)
    diff = (_model(kernel, *inputs) - _plain(kernel, *inputs)).abs()
    assert diff.max().item() < MAX_TOL / MARGIN
    assert diff.mean().item() < MEAN_TOL / MARGIN


@KERNELS
@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("level,heads,n_w,masked", SHAPES)
def test_split_model_matches_the_jax_package(kernel, pallas, level, heads,
                                             n_w, masked):
    """The JAX package's XLA path, and its Pallas TPU kernel run in
    interpret mode as the JAX package's own tests run it on the CPU."""
    inputs = _inputs(kernel, level, heads, n_w, masked)
    ref = _jax(kernel, *inputs, pallas=pallas)
    out = _model(kernel, *inputs).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < JAX_TOL


@KERNELS
@pytest.mark.parametrize("level,heads,n_w,masked", SHAPES)
def test_one_tf32_pass_misses_the_f32_bars(kernel, level, heads, n_w,
                                           masked):
    """A kernel that drops the lo terms reads 1e-3 max and 7e-5 mean: the
    bars catch it on both readings."""
    inputs = _inputs(kernel, level, heads, n_w, masked)
    diff = (_model(kernel, *inputs, passes=1)
            - _plain(kernel, *inputs)).abs()
    assert diff.max().item() > MAX_TOL
    assert diff.mean().item() > MEAN_TOL


def test_tf32_rounding_and_split():
    """cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties away from zero,
    either sign; hi + lo carries x to about 2^-22 of it."""
    one = 1.0
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
                      one + 3 * ulp / 2, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         -0.0], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * 10.0 ** rng.integers(-6, 6, 4096))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x.double() - hi.double() - lo.double()).abs()
            <= x.double().abs() * 2.0 ** -21).all()
