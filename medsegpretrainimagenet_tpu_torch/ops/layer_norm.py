"""LayerNorm over the last axis: the port's every LayerNorm
(``models.blocks.LayerNorm``, and through it ``HalfOutLayerNorm``,
``TorchLayerNorm`` and ``ChannelwiseLayerNorm``).

flax's semantics: statistics and the affine part in float32 (the promoted
type of the input and the float32 parameters), the output in that type, or
in the compute type for a half-output LayerNorm (*out_dtype*), rounded to it
as a cast rounds.

On a CUDA tensor the forward is the hand-written kernel in
``csrc/layer_norm.cu``, called as the registered torch operator
``torch.ops.medseg_torch.layer_norm``: it reads x in its own type (no
float32 copy is made or saved), and returns the output with the rows' mean
and reciprocal standard deviation.  Its gradient is the backward kernel of
the same file (``torch.ops.medseg_torch.layer_norm_backward``): dx in x's
type and, summed by blocks in a fixed order, dgamma and dbeta in float32.
There is no TPU kernel to port: the JAX package leaves flax's LayerNorm to
XLA.  On a CPU tensor the plain version runs, :func:`layer_norm_torch`
under autograd (the promote cast and ``F.layer_norm``); it and
:func:`layer_norm_backward` are the kernels' oracles on the card.  As K1's
wrappers do, an eager call with no gradient to record launches the kernel
straight, without the operator's dispatch.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .window_attention import _straight

__all__ = ["layer_norm", "layer_norm_torch", "layer_norm_stats",
           "layer_norm_backward", "layer_norm_cuda",
           "layer_norm_backward_cuda"]

#: element types of the C entry points
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _out_dtype(x: torch.Tensor, weight: torch.Tensor,
               out_dtype: Optional[torch.dtype]) -> torch.dtype:
    return out_dtype or torch.promote_types(x.dtype, weight.dtype)


def layer_norm_torch(x, weight, bias, eps: float,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch LayerNorm: x cast to the promoted type,
    ``F.layer_norm`` over the last axis, then the cast to *out_dtype*
    (none when it is the promoted type)."""
    x = x.to(torch.promote_types(x.dtype, weight.dtype))
    y = F.layer_norm(x, x.shape[-1:], weight, bias, eps)
    return y.to(_out_dtype(x, weight, out_dtype))


def layer_norm_stats(x, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows' mean and 1 / sqrt(variance + eps), in float32 or wider,
    of shape ``x.shape[:-1]``."""
    wide = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = wide.mean(-1)
    var = (wide - mean[..., None]).square().mean(-1)
    return mean, torch.rsqrt(var + eps)


def layer_norm_backward(dy, x, mean, rstd, weight):
    """The gradients of :func:`layer_norm_torch` from its rows' statistics:
    ``(dx, dgamma, dbeta)``, dx in x's type, dgamma and dbeta in the
    weight's, each computed in float32 or wider."""
    wide = torch.promote_types(torch.promote_types(x.dtype, weight.dtype),
                               dy.dtype)
    c = x.shape[-1]
    xhat = (x.to(wide) - mean[..., None].to(wide)) * rstd[..., None].to(wide)
    dyw = dy.to(wide)
    g = dyw * weight.to(wide)
    dx = rstd[..., None].to(wide) * (
        g - g.mean(-1, keepdim=True)
        - xhat * (g * xhat).mean(-1, keepdim=True))
    dgamma = (dyw * xhat).reshape(-1, c).sum(0)
    dbeta = dyw.reshape(-1, c).sum(0)
    return dx.to(x.dtype), dgamma.to(weight.dtype), dbeta.to(weight.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _library():
    lib = _build.library("layer_norm")
    if not getattr(lib, "_medseg_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.medseg_layer_norm_forward.argtypes = [
            p, i, p, p, p, i, p, p, ll, i, ctypes.c_float, p]
        lib.medseg_layer_norm_forward.restype = i
        lib.medseg_layer_norm_backward_slots.argtypes = [
            p, i, p, i, p, p, ll, i]
        lib.medseg_layer_norm_backward_slots.restype = ll
        lib.medseg_layer_norm_backward.argtypes = [
            p, i, p, i, p, p, p, p, p, ll, p, p, ll, i, p]
        lib.medseg_layer_norm_backward.restype = i
        lib._medseg_typed = True
    return lib


def _check(x, weight, bias, out_dtype: torch.dtype) -> None:
    """What the kernels take: x of bf16, fp16 or float32 with its last
    axis C, float32 (C,) weight and bias on x's device, an output of bf16,
    fp16 or float32.  Shapes are checked on symbolic sizes too (the fake
    implementations)."""
    if x.dim() < 1:
        raise ValueError("the layer-norm kernel needs at least one axis")
    for name, dtype in (("x", x.dtype), ("the output", out_dtype)):
        if dtype not in _KINDS:
            raise ValueError(f"the layer-norm kernel takes bfloat16, float16 "
                             f"or float32 for {name}, got {dtype}")
    c = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None or tuple(t.shape) != (c,) or t.dtype != torch.float32 \
                or t.device != x.device:
            raise ValueError(
                f"the layer-norm kernel needs a float32 {name} of ({c},) on "
                f"{x.device}, got "
                + ("None" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}"))


def _check_cuda(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the {kernel} kernel needs CUDA tensors, got "
                             f"{name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel needs contiguous inputs; "
                             f"{name} is not")


def layer_norm_cuda(x, weight, bias, eps: float,
                    out_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on the current stream: ``(y, mean,
    rstd)``, y in *out_dtype* (the promoted type when None), mean and rstd
    float32 of shape ``x.shape[:-1]``.  Raises on inputs it does not take or
    if the launch is refused."""
    out_dtype = _out_dtype(x, weight, out_dtype)
    _check(x, weight, bias, out_dtype)
    _check_cuda("layer-norm", x=x, weight=weight, bias=bias)
    c = x.shape[-1]
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    rows = x.numel() // c if c else 0
    with torch.cuda.device(x.device):
        err = _library().medseg_layer_norm_forward(
            x.data_ptr(), _KINDS[x.dtype], weight.data_ptr(),
            bias.data_ptr(), y.data_ptr(), _KINDS[out_dtype],
            mean.data_ptr(), rstd.data_ptr(), rows, c, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer-norm kernel launch failed with error "
                           f"{err} for x {tuple(x.shape)} {x.dtype}")
    layer_norm_cuda.launches += 1
    return y, mean, rstd


#: launches of the forward kernel since the count was last set to 0
layer_norm_cuda.launches = 0


def layer_norm_backward_cuda(dy, x, mean, rstd, weight, x_grad: bool = True,
                             weight_grad: bool = True):
    """The gradients by the backward kernel, on the current stream:
    ``(dx, dgamma, dbeta)`` as :func:`layer_norm_backward` gives them, dx
    None unless *x_grad*, dgamma and dbeta None unless *weight_grad* (then
    no partial sums are written or added up).  Raises on inputs it does not
    take or if a launch is refused."""
    _check(x, weight, weight, dy.dtype)
    _check_cuda("layer-norm backward", dy=dy, x=x, mean=mean, rstd=rstd,
                weight=weight)
    c = x.shape[-1]
    if dy.shape != x.shape or mean.shape != x.shape[:-1] \
            or rstd.shape != mean.shape or mean.dtype != torch.float32 \
            or rstd.dtype != torch.float32:
        raise ValueError(f"the layer-norm backward needs dy of x's shape "
                         f"{tuple(x.shape)} and float32 mean and rstd of "
                         f"{tuple(x.shape[:-1])}, got dy {tuple(dy.shape)}, "
                         f"mean {mean.dtype} {tuple(mean.shape)}, rstd "
                         f"{rstd.dtype} {tuple(rstd.shape)}")
    rows = x.numel() // c if c else 0
    dx = torch.empty_like(x) if x_grad else None
    dgamma = dbeta = partial = None
    lib = _library()
    dx_ptr = None if dx is None else dx.data_ptr()
    with torch.cuda.device(x.device):
        slots = 0
        if weight_grad:
            # no rows: no launch, and gradients of 0
            alloc = torch.empty if rows else torch.zeros
            dgamma, dbeta = (alloc(c, dtype=torch.float32, device=x.device)
                             for _ in range(2))
        if weight_grad and rows:
            slots = lib.medseg_layer_norm_backward_slots(
                dy.data_ptr(), _KINDS[dy.dtype], x.data_ptr(),
                _KINDS[x.dtype], weight.data_ptr(), dx_ptr, rows, c)
            if slots < 1:
                raise RuntimeError(f"layer-norm backward: no grid for {rows} "
                                   f"rows of {c} (error {-slots})")
            partial = torch.empty(slots * 2 * c, dtype=torch.float32,
                                  device=x.device)
        err = lib.medseg_layer_norm_backward(
            dy.data_ptr(), _KINDS[dy.dtype], x.data_ptr(), _KINDS[x.dtype],
            mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(), dx_ptr,
            None if partial is None else partial.data_ptr(), slots,
            None if dgamma is None else dgamma.data_ptr(),
            None if dbeta is None else dbeta.data_ptr(), rows, c,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer-norm backward kernel launch failed with "
                           f"error {err} for x {tuple(x.shape)} {x.dtype}, "
                           f"dy {dy.dtype}")
    layer_norm_backward_cuda.launches += 1
    return dx, dgamma, dbeta


#: launches of the backward kernel since the count was last set to 0
layer_norm_backward_cuda.launches = 0


# ---------------------------------------------------------------------------
# The operators and their gradient
# ---------------------------------------------------------------------------

@torch.library.custom_op("medseg_torch::layer_norm", mutates_args=(),
                         device_types="cuda")
def _layer_norm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float, out_dtype: torch.dtype) -> List[torch.Tensor]:
    """The forward kernel as a torch operator: [y, mean, rstd].  On the
    card :func:`layer_norm_cuda`; on the CPU the plain version."""
    return list(layer_norm_cuda(x, weight, bias, eps, out_dtype))


@_layer_norm_op.register_kernel("cpu")
def _layer_norm_plain(x, weight, bias, eps, out_dtype):
    mean, rstd = layer_norm_stats(x, eps)
    return [layer_norm_torch(x, weight, bias, eps, out_dtype), mean, rstd]


@_layer_norm_op.register_fake
def _layer_norm_fake(x, weight, bias, eps, out_dtype):
    """The outputs' shapes and dtypes, after :func:`_check`'s checks."""
    _check(x, weight, bias, out_dtype)
    mean = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return [x.new_empty(x.shape, dtype=out_dtype), mean,
            torch.empty_like(mean)]


def _grads_list(dx, dgamma, dbeta) -> List[torch.Tensor]:
    return [t for t in (dx, dgamma, dbeta) if t is not None]


@torch.library.custom_op("medseg_torch::layer_norm_backward",
                         mutates_args=(), device_types="cuda")
def _layer_norm_backward_op(
        dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
        rstd: torch.Tensor, weight: torch.Tensor, x_grad: bool,
        weight_grad: bool) -> List[torch.Tensor]:
    """The backward kernel as a torch operator: [dx] if *x_grad*, then
    [dgamma, dbeta] if *weight_grad*.  On the card
    :func:`layer_norm_backward_cuda`; on the CPU its plain version."""
    return _grads_list(*layer_norm_backward_cuda(dy, x, mean, rstd, weight,
                                                 x_grad, weight_grad))


@_layer_norm_backward_op.register_kernel("cpu")
def _layer_norm_backward_plain(dy, x, mean, rstd, weight, x_grad,
                               weight_grad):
    dx, dgamma, dbeta = layer_norm_backward(dy, x, mean, rstd, weight)
    return _grads_list(dx if x_grad else None,
                       *((dgamma, dbeta) if weight_grad else (None, None)))


@_layer_norm_backward_op.register_fake
def _layer_norm_backward_fake(dy, x, mean, rstd, weight, x_grad,
                              weight_grad):
    _check(x, weight, weight, dy.dtype)
    return _grads_list(torch.empty_like(x) if x_grad else None,
                       *((torch.empty_like(weight), torch.empty_like(weight))
                         if weight_grad else (None, None)))


def _save_inputs(ctx, inputs, output):
    x, weight, _, _, _ = inputs
    _, mean, rstd = output
    ctx.mark_non_differentiable(mean, rstd)
    ctx.save_for_backward(x, weight, mean, rstd)


def _layer_norm_grad(ctx, grads):
    """The backward operator, asked for dx and for dgamma and dbeta only
    where they need a gradient."""
    x, weight, mean, rstd = ctx.saved_tensors
    x_grad = ctx.needs_input_grad[0]
    weight_grad = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
    out = torch.ops.medseg_torch.layer_norm_backward(
        grads[0].contiguous(), x, mean, rstd, weight, x_grad, weight_grad)
    dx = out[0] if x_grad else None
    dgamma, dbeta = out[-2:] if weight_grad else (None, None)
    return (dx, dgamma if ctx.needs_input_grad[1] else None,
            dbeta if ctx.needs_input_grad[2] else None, None, None)


_layer_norm_op.register_autograd(_layer_norm_grad, setup_context=_save_inputs)


def layer_norm(x, weight, bias, eps: float,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis of *x*, the output in *out_dtype* (the
    promoted type of x and the weight when None).  Dispatch on where x
    lies: the kernels for a CUDA tensor (they raise on what they do not
    take; there is no fallback), the plain version for a CPU tensor.  Under
    autograd and under tracing the kernel is the operator
    ``medseg_torch::layer_norm``, its gradient the backward kernel; an
    eager no-grad call launches the forward straight."""
    out_dtype = _out_dtype(x, weight, out_dtype)
    if x.device.type == "cpu":
        return layer_norm_torch(x, weight, bias, eps, out_dtype)
    x = x.contiguous()
    if _straight(x, weight, bias):
        return layer_norm_cuda(x, weight, bias, eps, out_dtype)[0]
    return torch.ops.medseg_torch.layer_norm(x, weight, bias, float(eps),
                                             out_dtype)[0]
