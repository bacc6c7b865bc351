"""The port's window attention (``medsegpretrainimagenet_tpu_torch.ops``)
against the JAX package's: the plain PyTorch version against the XLA path
and the Pallas kernel (interpret mode), the recompute backward against
``jax.grad``, and CPU dispatch.  The CUDA kernel itself is held against the
plain version on the card in ``test_torch_kernels_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.ops import window_attention as jax_wa
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

SCALE = 0.25


def _inputs(seed, b_=8, h=2, n=16, d=8, n_w=4, masked=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b_, h, n, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = rng.standard_normal((n_w, n, n)).astype(np.float32) \
        if masked else None
    return q, k, v, bias, mask


def _torch(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(
        dtype if i < 3 else torch.float32) for i, a in enumerate(arrays)]


def _jax(arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype if i < 3
                                               else jnp.float32)
            for i, a in enumerate(arrays)]


#: (N, D) at the edges of what the CUDA kernel takes, and swin_unet_224's
#: (49, 32): the plain version, which the card's tests trust as the
#: kernel's oracle, equals the JAX package's at each.  The first shape
#: keeps the ids the test had before it took a shape.
EDGE_SHAPES = [pytest.param(masked, n, d, id=("sw_msa" if masked else "w_msa")
                            + suffix)
               for n, d, suffix in ((16, 8, ""), (49, 32, "-49x32"),
                                    (64, 64, "-64x64"))
               for masked in (False, True)]


@pytest.mark.parametrize("masked,n,d", EDGE_SHAPES)
def test_plain_matches_xla_path(masked, n, d):
    arrays = _inputs(0, n=n, d=d, masked=masked)
    ref = jax_wa._xla_window_attention(*_jax(arrays), SCALE)
    out = wa.window_attention_torch(*_torch(arrays), SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["w_msa", "sw_msa"])
def test_plain_matches_pallas_kernel_interpret(masked):
    """The TPU kernel, run in Pallas interpret mode on the CPU, is the
    function the CUDA kernel replaces."""
    from jax.experimental.pallas import tpu as pltpu

    arrays = _inputs(1, masked=masked)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_wa.window_attention_core(*_jax(arrays), SCALE,
                                           force="pallas")
    out = wa.window_attention_torch(*_torch(arrays), SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_plain_bf16_keeps_the_jax_rounding_points():
    """bf16 in, bf16 out: q*scale rounds in bf16, probabilities round to
    bf16 before P.V.  The two differ only in float32 summation order, so
    at most one bf16 rounding step (2^-8 relative) apart."""
    arrays = _inputs(2, n=49, d=32, h=3, b_=8)
    scale = 32 ** -0.5
    ref = np.asarray(jax_wa._xla_window_attention(
        *_jax(arrays, jnp.bfloat16), scale).astype(jnp.float32))
    out = wa.window_attention_torch(*_torch(arrays, torch.bfloat16), scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref,
                               rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True], ids=["w_msa", "sw_msa"])
def test_recompute_backward_matches_jax_grad(masked):
    """``window_attention_backward`` (the backward operator's CPU kernel,
    and the backward kernel's oracle on the card) gives jax.grad's dq, dk,
    dv, dbias and the summed dmask."""
    arrays = _inputs(3, masked=masked)
    g = np.random.default_rng(4).standard_normal(
        arrays[0].shape).astype(np.float32)
    argnums = (0, 1, 2, 3, 4) if masked else (0, 1, 2, 3)

    def loss(*args):
        if not masked:
            args = (*args, None)
        return jnp.sum(jax_wa._xla_window_attention(*args, SCALE) * g)

    jax_args = _jax(arrays)[:len(argnums)]
    ref = jax.grad(loss, argnums=argnums)(*jax_args)
    grads = wa.window_attention_backward(*_torch(arrays), SCALE,
                                         torch.from_numpy(g))
    assert (grads[4] is None) == (not masked)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_autograd_through_plain_version_matches_jax_grad():
    arrays = _inputs(5)
    ts = [t.requires_grad_() for t in _torch(arrays)]
    (wa.window_attention_torch(*ts, SCALE) ** 2).sum().backward()

    def loss(*args):
        return jnp.sum(jax_wa._xla_window_attention(*args, SCALE) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*_jax(arrays))
    for t, want in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("force", [None, "torch"])
def test_cpu_dispatch_runs_plain_version_and_counts_no_launch(force):
    arrays = _torch(_inputs(6))
    wa.window_attention_cuda.launches = 0
    out = wa.window_attention_core(*arrays, SCALE, force=force)
    np.testing.assert_array_equal(
        out.numpy(), wa.window_attention_torch(*arrays, SCALE).numpy())
    assert wa.window_attention_cuda.launches == 0


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, bias, mask = _torch(_inputs(7))
    with pytest.raises(ValueError, match="CUDA"):
        wa.window_attention_cuda(q, k, v, bias, mask, SCALE)
    with pytest.raises(ValueError, match="force"):
        wa.window_attention_core(q, k, v, bias, mask, SCALE, force="xla")
