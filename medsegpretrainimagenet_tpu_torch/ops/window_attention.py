"""Window attention: softmax(q k^T * scale + bias [+ mask]) v.

The port of ``medsegpretrainimagenet_tpu/ops/window_attention.py``.  On a
CUDA tensor the forward is the hand-written kernel in
``csrc/window_attention.cu`` (the counterpart of the Pallas TPU kernel
``_pallas_window_attention``), called as the registered torch operator
``torch.ops.medseg_torch.window_attention``: ``torch.export`` keeps it as a
node of the graph (its fake implementation gives the output's shape).  Its
gradient is the hand-written backward kernel in
``csrc/window_attention_bwd.cu`` (the counterpart of the JAX custom VJP
``_fused_bwd``: the probabilities recomputed on the chip), the operator
``torch.ops.medseg_torch.window_attention_backward``.  On a CPU tensor the
plain PyTorch versions run: :func:`window_attention_torch` under autograd,
and :func:`window_attention_backward` as the backward operator's CPU
kernel; both are also the kernels' oracles on the card.  An eager call
with no gradient to record (serving) calls the forward kernel straight,
without the operator's dispatch.  Importing this module registers the
operators; a program exported on the card needs that
(``export.load_exported`` imports it).

``window_attention_core(q, k, v, bias, mask, scale)``:
  q, k, v: (B_, H, N, D)   bias: (H, N, N)   mask: (nW, N, N) or None,
  where B_ = batch * nW.  Returns (B_, H, N, D).

The image-layout path does the same attention straight from the (B, R, R,
3C) output of the qkv projection: window partition, head split, attention,
head merge and window reverse in one kernel, ``csrc/image_attention.cu``
(the counterpart of ``_pallas_image_attention``), the operator
``torch.ops.medseg_torch.image_attention``, with the plain version
:func:`image_attention_torch`; its gradient is ``csrc/image_attention_bwd.cu``
(``torch.ops.medseg_torch.image_attention_backward``), which writes dqkv
straight into the image layout, with the plain version
:func:`image_attention_backward`.  ``set_fused_image_mode`` switches the Swin
blocks onto it, as in the JAX package; it is off by default.

``fused_image_window_attention(qkv, bias, mask, scale, window)``:
  qkv: (B, Rh, Rw, 3C)   bias: (H, N, N)   mask: ((Rh/w)(Rw/w), N, N) or
  None, with N = window^2.  Returns (B, Rh, Rw, C).  The image is a square
  (Rh = Rw) but for a band of rows under spatial sharding, which passes the
  rows of the global mask that its windows take.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional

import numpy as np
import torch

from . import _build

__all__ = ["window_attention_core", "window_attention_torch",
           "window_attention_cuda", "window_attention_backward",
           "window_attention_backward_cuda",
           "fused_image_window_attention", "image_attention_torch",
           "image_attention_cuda", "image_attention_backward",
           "image_attention_backward_cuda",
           "set_fused_image_mode", "use_fused_image"]

#: largest window (tokens) and head width the kernel takes
MAX_TOKENS = 64
MAX_HEAD_DIM = 64


def _rounded(scale: float, dtype: torch.dtype) -> float:
    """*scale* rounded to *dtype* as torch rounds it, and JAX a weak-typed
    python scalar: on the host, so a traced forward records a constant and
    no tensor.  bfloat16 keeps 8 significant bits, to nearest even."""
    if dtype == torch.bfloat16 and scale != 0:
        mantissa, exponent = math.frexp(scale)
        return math.ldexp(round(mantissa * 2 ** 8), exponent - 8)
    if dtype == torch.float16:
        return float(np.float16(np.float32(scale)))
    if dtype == torch.float32:
        return float(np.float32(scale))
    return float(scale)


def _logits(q, k, bias, mask, scale):
    # q * scale in the input dtype (scale rounded to it first, as JAX's
    # weak-typed python scalar is), then a float32 product: bf16 inputs
    # multiply exactly in float32, like preferred_element_type=float32
    qs = q * _rounded(scale, q.dtype)
    logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    # the bias added in its own dtype where it is wider than float32 (a
    # float64 model), so that its gradient sums the windows' terms in it:
    # they then add up alike in any order, in one process or over bands of
    # rows; a float32 bias adds as it always did
    wide = torch.promote_types(logits.dtype, bias.dtype)
    logits = (logits.to(wide) + bias[None]).float()
    if mask is not None:
        n_w = mask.shape[0]
        b_, h, n, _ = logits.shape
        logits = logits.reshape(b_ // n_w, n_w, h, n, n) \
            + mask[None, :, None].float()
        logits = logits.reshape(b_, h, n, n)
    return logits


def window_attention_torch(q, k, v, bias, mask: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """Plain PyTorch window attention: the counterpart of the JAX package's
    ``_xla_window_attention``, with the same rounding points."""
    probs = torch.softmax(_logits(q, k, bias, mask, scale), dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def window_attention_backward(q, k, v, bias, mask, scale, g):
    """Gradients of window attention by recomputing the probabilities: the
    port of the JAX custom VJP's ``_fused_bwd``.  Returns
    ``(dq, dk, dv, dbias, dmask)``; ``dmask`` is None without a mask."""
    probs = torch.softmax(_logits(q, k, bias, mask, scale), dim=-1)
    g32 = g.float()
    dv = torch.matmul(probs.transpose(-1, -2), g32)
    dprobs = torch.matmul(g32, v.float().transpose(-1, -2))
    dlogits = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True))
    dq = scale * torch.matmul(dlogits, k.float())
    dk = scale * torch.matmul(dlogits.transpose(-1, -2), q.float())
    dbias = dlogits.sum(0)
    dmask = None
    if mask is not None:
        # the mask broadcasts as (1, nW, 1, N, N) into the (B_/nW, nW, H,
        # N, N) logits, so its cotangent sums over batch groups and heads
        n_w = mask.shape[0]
        b_, h, n, _ = dlogits.shape
        dmask = dlogits.reshape(b_ // n_w, n_w, h, n, n).sum(dim=(0, 2))
        dmask = dmask.to(mask.dtype)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            dbias.to(bias.dtype), dmask)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
    + [ctypes.c_float, ctypes.c_void_p]


def _entry(dtype: torch.dtype):
    lib = _build.library("window_attention")
    fn = lib.window_attention_fwd_bf16 if dtype == torch.bfloat16 \
        else lib.window_attention_fwd_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_input(kernel: str, name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the {kernel} kernel needs CUDA tensors, got "
                         f"{name} on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the {kernel} kernel takes bfloat16 or float32, "
                         f"got {x.dtype}")


def _check_tables_and_layout(kernel: str, device: torch.device,
                             tables: dict, operands: dict) -> None:
    """*tables*: {name: (tensor or None, shape)}, each float32 of that
    shape on *device*; *operands*: {name: tensor or None}, each
    contiguous."""
    for name, (t, shape) in tables.items():
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32
                              or t.device != device):
            raise ValueError(f"{name} must be float32 {shape} on {device},"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in operands.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"the {kernel} kernel needs contiguous inputs; "
                             f"{name} is not")


def _check(q, k, v, bias, mask):
    _check_input("window-attention", "q", q)
    if q.dim() != 4:
        raise ValueError(f"q must be (B_, H, N, D), got {tuple(q.shape)}")
    b_, heads, n, d = q.shape
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"the window-attention kernel takes N <= "
                         f"{MAX_TOKENS} and D <= {MAX_HEAD_DIM}, got N={n}, "
                         f"D={d}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} "
                             f"{t.dtype} {t.device} vs {tuple(q.shape)} "
                             f"{q.dtype} {q.device}")
    if mask is not None and (mask.dim() != 3 or mask.shape[0] < 1
                             or b_ % mask.shape[0]):
        raise ValueError(f"mask must be (nW, N, N) with nW dividing "
                         f"B_={b_}, got {tuple(mask.shape)}")
    _check_tables_and_layout(
        "window-attention", q.device,
        {"bias": (bias, (heads, n, n)),
         "mask": (mask, None if mask is None else (mask.shape[0], n, n))},
        {"q": q, "k": k, "v": v, "bias": bias, "mask": mask})


def window_attention_cuda(q, k, v, bias, mask: Optional[torch.Tensor],
                          scale: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on inputs it
    does not take or if the launch is refused."""
    _check(q, k, v, bias, mask)
    b_, heads, n, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b_, heads, n, d, 1 if mask is None else mask.shape[0], scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window-attention kernel launch failed with CUDA "
                           f"error {err} for q {tuple(q.shape)} {q.dtype}")
    window_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
window_attention_cuda.launches = 0


def _window_attention_fake(q, k, v, bias, mask, scale):
    """The output's shape and dtype, after :func:`_check`'s checks (on a
    traced batch its sizes are symbolic, and the checks decide on them
    without pinning the batch)."""
    _check(q, k, v, bias, mask)
    return torch.empty_like(q)


@torch.library.custom_op("medseg_torch::window_attention", mutates_args=())
def _window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, mask: Optional[torch.Tensor],
                         scale: float) -> torch.Tensor:
    """K1 as a torch operator: :func:`window_attention_cuda`, which raises
    on a tensor that is not on the card."""
    return window_attention_cuda(q, k, v, bias, mask, scale)


# ---------------------------------------------------------------------------
# The backward kernels and the operators' gradients
# ---------------------------------------------------------------------------

_GRAD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 \
    + [ctypes.c_float, ctypes.c_void_p]
_IMAGE_GRAD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]

#: {(kernel, dtype, shape arguments): partial tiles}: a backward's scratch
#: for its blocks' dS sums, as many tiles as its grid has blocks
_TILES: dict = {}


def _grad_entry(kernel: str, dtype: torch.dtype, tiles: bool = False):
    """The C entry point of *kernel*'s backward (``window_attention`` or
    ``image_attention``) for *dtype*, or with *tiles* the one that gives
    the number of partial tiles its launch needs."""
    lib = _build.library(f"{kernel}_bwd")
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    if tiles:
        fn = getattr(lib, f"{kernel}_bwd_tiles_{suffix}")
        fn.argtypes = [ctypes.c_int] * (6 if kernel == "window_attention"
                                        else 7)
        fn.restype = ctypes.c_longlong
    else:
        fn = getattr(lib, f"{kernel}_bwd_{suffix}")
        fn.argtypes = _GRAD_ARGTYPES if kernel == "window_attention" \
            else _IMAGE_GRAD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _partials(kernel: str, dtype: torch.dtype, device: torch.device,
              n: int, shape: tuple):
    """(scratch, tiles): float32 scratch for the dS sums of the blocks of
    *kernel*'s backward at *shape* (its tiles entry point's arguments)."""
    key = (kernel, dtype, device.index, shape)
    tiles = _TILES.get(key)
    if tiles is None:
        tiles = _grad_entry(kernel, dtype, tiles=True)(*shape)
        if tiles < 1:
            raise RuntimeError(f"{kernel} backward: no grid for {shape} "
                               f"{dtype} (CUDA error {-tiles})")
        _TILES[key] = tiles
    return torch.empty(tiles * n * n, dtype=torch.float32,
                       device=device), tiles


def _check_grad(kernel: str, g: torch.Tensor, shape: tuple,
                like: torch.Tensor) -> None:
    if tuple(g.shape) != shape or g.dtype != like.dtype \
            or g.device != like.device:
        raise ValueError(f"the {kernel} backward needs g of {shape} "
                         f"{like.dtype} on {like.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError(f"the {kernel} backward needs a contiguous g")


def window_attention_backward_cuda(q, k, v, bias, mask, scale: float, g,
                                   bias_grad: bool = True,
                                   mask_grad: bool = True):
    """Gradients of window attention by the backward kernel, on the current
    stream: ``(dq, dk, dv, dbias, dmask)`` as
    :func:`window_attention_backward` gives them, with dbias None unless
    *bias_grad* and dmask None unless *mask_grad* and there is a mask (the
    blocks' dS sums are then neither written nor added up).  Raises on
    inputs it does not take or if a launch is refused."""
    _check(q, k, v, bias, mask)
    _check_grad("window-attention", g, tuple(q.shape), q)
    b_, heads, n, d = q.shape
    n_w = 1 if mask is None else mask.shape[0]
    mask_grad = mask_grad and mask is not None
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias) if bias_grad else None
    dmask = torch.empty_like(mask) if mask_grad else None
    with torch.cuda.device(q.device):
        partial, tiles = _partials(
            "window_attention", q.dtype, q.device, n,
            (b_, heads, n, d, n_w, int(mask is not None))) \
            if bias_grad or mask_grad else (None, 0)
        err = _grad_entry("window_attention", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            bias.data_ptr(), None if mask is None else mask.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if partial is None else partial.data_ptr(), tiles,
            None if dbias is None else dbias.data_ptr(),
            None if dmask is None else dmask.data_ptr(),
            b_, heads, n, d, n_w, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window-attention backward kernel launch failed "
                           f"with CUDA error {err} for q {tuple(q.shape)} "
                           f"{q.dtype}")
    window_attention_backward_cuda.launches += 1
    return dq, dk, dv, dbias, dmask


#: launches of the backward kernel since the count was last set to 0
window_attention_backward_cuda.launches = 0


def _grads_list(grads, bias_grad: bool, mask_grad: bool) -> List:
    """A backward's gradients, (dq, dk, dv, dbias, dmask) or (dqkv, dbias,
    dmask) -> the operator's list: the inputs' gradients, then dbias if
    asked for, then dmask if asked for."""
    *inputs, dbias, dmask = grads
    return [*inputs, *([dbias] if bias_grad else []),
            *([dmask] if mask_grad else [])]


@torch.library.custom_op("medseg_torch::window_attention_backward",
                         mutates_args=(), device_types="cuda")
def _window_attention_backward_op(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: torch.Tensor, mask: Optional[torch.Tensor], g: torch.Tensor,
        scale: float, bias_grad: bool, mask_grad: bool) -> List[torch.Tensor]:
    """K1's backward as a torch operator: [dq, dk, dv], then dbias if
    *bias_grad*, then dmask if *mask_grad* (only with a mask).  On the card
    :func:`window_attention_backward_cuda`; on the CPU its plain version
    (the kernel has no CPU mode)."""
    mask_grad = mask_grad and mask is not None
    return _grads_list(window_attention_backward_cuda(
        q, k, v, bias, mask, scale, g, bias_grad, mask_grad),
        bias_grad, mask_grad)


@_window_attention_backward_op.register_kernel("cpu")
def _window_attention_backward_plain(q, k, v, bias, mask, g, scale,
                                     bias_grad, mask_grad):
    mask_grad = mask_grad and mask is not None
    return _grads_list(window_attention_backward(q, k, v, bias, mask, scale,
                                                 g), bias_grad, mask_grad)


@_window_attention_backward_op.register_fake
def _window_attention_backward_fake(q, k, v, bias, mask, g, scale,
                                    bias_grad, mask_grad):
    _check(q, k, v, bias, mask)
    mask_grad = mask_grad and mask is not None
    return _grads_list((torch.empty_like(q), torch.empty_like(k),
                        torch.empty_like(v), torch.empty_like(bias),
                        None if mask is None else torch.empty_like(mask)),
                       bias_grad, mask_grad)


def _save_inputs(ctx, inputs, output):
    q, k, v, bias, mask, ctx.scale = inputs
    ctx.save_for_backward(q, k, v, bias, mask)


def _window_attention_grad(ctx, g):
    """The backward operator, asked for dbias and dmask only where they
    need a gradient."""
    q, k, v, bias, mask = ctx.saved_tensors
    bias_grad = ctx.needs_input_grad[3]
    mask_grad = mask is not None and ctx.needs_input_grad[4]
    grads = torch.ops.medseg_torch.window_attention_backward(
        q, k, v, bias, mask, g.contiguous(), ctx.scale, bias_grad, mask_grad)
    dbias = grads[3] if bias_grad else None
    dmask = grads[-1] if mask_grad else None
    return grads[0], grads[1], grads[2], dbias, dmask, None


_window_attention_op.register_fake(_window_attention_fake)
_window_attention_op.register_autograd(_window_attention_grad,
                                       setup_context=_save_inputs)


def _impl(force: Optional[str], device: torch.device) -> str:
    if force not in (None, "torch"):
        raise ValueError(f"force must be None or 'torch', got {force!r}")
    return "torch" if force == "torch" or device.type == "cpu" else "kernel"


def _straight(*tensors) -> bool:
    """Whether the kernel is called straight, without the operator's
    dispatch (tens of microseconds of host time a call on the serving
    path, PERF.md): in eager mode with no gradient to record.  Tracing
    (``torch.export``, ``torch.compile``) and autograd take the operator."""
    if torch.compiler.is_compiling():
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors))


def window_attention_core(q, k, v, bias, mask: Optional[torch.Tensor],
                          scale: float, force: Optional[str] = None,
                          train: bool = False) -> torch.Tensor:
    """Dispatch on where q lies: the CUDA kernel for a CUDA tensor (it
    raises on what it does not take; there is no fallback), the plain
    version for a CPU tensor.  ``force="torch"`` pins the plain version
    (tests, and the kernel's comparison on the card).  Under autograd and
    under tracing the kernel is the operator ``medseg_torch::
    window_attention``, its gradient the backward kernel (the operator
    ``medseg_torch::window_attention_backward``); an eager no-grad call
    launches the forward straight (:func:`_straight`).

    ``train`` is the JAX package's flag, which sends training to XLA on a
    TPU.  It changes nothing here: training takes the forward kernel and
    its backward kernel on the card (chip_smoke.py ``[swin train]`` times
    the step on them against the plain version under autograd,
    PERF.md)."""
    if _impl(force, q.device) == "torch":
        return window_attention_torch(q, k, v, bias, mask, scale)
    if _straight(q, k, v, bias, mask):
        return window_attention_cuda(q, k, v, bias, mask, scale)
    return torch.ops.medseg_torch.window_attention(q, k, v, bias, mask,
                                                   float(scale))


# ---------------------------------------------------------------------------
# Image-layout path: window partition + head split + attention + head merge
# + window reverse in one kernel
# ---------------------------------------------------------------------------

def _image_windows(qkv, heads: int, window: int):
    """(B, Rh, Rw, 3C) -> (3, B_, H, N, D): window partition and head
    split, the layout of :func:`window_attention_torch`'s q, k and v."""
    b, rows, cols, c3 = qkv.shape
    t = qkv.reshape(b, rows // window, window, cols // window, window, c3)
    t = t.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, 3, heads,
                                            c3 // 3 // heads)
    return t.permute(2, 0, 3, 1, 4)


def image_attention_torch(qkv, bias, mask: Optional[torch.Tensor],
                          scale: float, window: int) -> torch.Tensor:
    """Plain PyTorch image-layout window attention: the counterpart of the
    JAX package's ``_xla_image_attention``, the op sequence the kernel
    replaces.  qkv: (B, Rh, Rw, 3C) -> out: (B, Rh, Rw, C)."""
    b, rows, cols, c3 = qkv.shape
    c = c3 // 3
    t = _image_windows(qkv, bias.shape[0], window)
    out = window_attention_torch(t[0], t[1], t[2], bias, mask, scale)
    out = out.transpose(1, 2).reshape(b, rows // window, cols // window,
                                      window, window, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, rows, cols, c)


def image_attention_backward(qkv, bias, mask, scale, window, g):
    """Gradients of image-layout attention: the recompute backward of the
    windows layout (:func:`window_attention_backward`) on the partitioned
    qkv, its dq, dk and dv merged back into the image layout.  The port of
    the JAX custom VJP's ``_fused_image_bwd`` (the vjp of the XLA op
    sequence).  Returns ``(dqkv, dbias, dmask)``; ``dmask`` is None without
    a mask."""
    b, rows, cols, c3 = qkv.shape
    heads, n_wr, n_wc = bias.shape[0], rows // window, cols // window
    t = _image_windows(qkv, heads, window)
    # g (B, Rh, Rw, C) -> (B_, H, N, D), as the forward's out before its
    # merge
    g = g.reshape(b, n_wr, window, n_wc, window, heads, c3 // 3 // heads)
    g = g.permute(0, 1, 3, 2, 4, 5, 6).reshape(-1, window * window, heads,
                                               c3 // 3 // heads)
    dq, dk, dv, dbias, dmask = window_attention_backward(
        t[0], t[1], t[2], bias, mask, scale, g.transpose(1, 2))
    d = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)  # (B_, N, 3, H, D)
    d = d.reshape(b, n_wr, n_wc, window, window, c3)
    dqkv = d.permute(0, 1, 3, 2, 4, 5).reshape(b, rows, cols, c3)
    return dqkv, dbias, dmask


_IMAGE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_void_p]


def _image_entry(dtype: torch.dtype):
    lib = _build.library("image_attention")
    fn = lib.image_attention_fwd_bf16 if dtype == torch.bfloat16 \
        else lib.image_attention_fwd_f32
    fn.argtypes = _IMAGE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check_image(qkv, bias, mask, window):
    _check_input("image-attention", "qkv", qkv)
    if qkv.dim() != 4 or qkv.shape[3] % 3:
        raise ValueError(f"qkv must be (B, Rh, Rw, 3C), got "
                         f"{tuple(qkv.shape)}")
    b, rows, cols, c3 = qkv.shape
    if window < 1 or rows % window or cols % window:
        raise ValueError(f"the image-attention kernel needs Rh and Rw to "
                         f"divide by the window, got Rh={rows}, Rw={cols}, "
                         f"window={window}")
    if bias.dim() != 3 or bias.shape[0] < 1 or (c3 // 3) % bias.shape[0]:
        raise ValueError(f"bias must be (H, N, N) with H dividing C="
                         f"{c3 // 3}, got {tuple(bias.shape)}")
    n, d = window * window, c3 // 3 // bias.shape[0]
    if n > MAX_TOKENS or d > MAX_HEAD_DIM:
        raise ValueError(f"the image-attention kernel takes N <= "
                         f"{MAX_TOKENS} and D <= {MAX_HEAD_DIM}, got N={n}, "
                         f"D={d}")
    # window (i, j) of the Rh/w x Rw/w grid takes mask row i * Rw/w + j
    _check_tables_and_layout(
        "image-attention", qkv.device,
        {"bias": (bias, (bias.shape[0], n, n)),
         "mask": (mask, ((rows // window) * (cols // window), n, n))},
        {"qkv": qkv, "bias": bias, "mask": mask})


def image_attention_cuda(qkv, bias, mask: Optional[torch.Tensor],
                         scale: float, window: int) -> torch.Tensor:
    """Launch the image-layout CUDA kernel on the current stream.  Raises on
    inputs it does not take or if the launch is refused."""
    _check_image(qkv, bias, mask, window)
    b, rows, cols, c3 = qkv.shape
    out = torch.empty((b, rows, cols, c3 // 3), dtype=qkv.dtype,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _image_entry(qkv.dtype)(
            qkv.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, rows, cols, c3 // 3, bias.shape[0], window, scale,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"image-attention kernel launch failed with CUDA "
                           f"error {err} for qkv {tuple(qkv.shape)} "
                           f"{qkv.dtype}")
    image_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
image_attention_cuda.launches = 0


def _image_attention_fake(qkv, bias, mask, scale, window):
    """The output's shape and dtype, after :func:`_check_image`'s checks
    (on symbolic sizes, as :func:`_window_attention_fake`)."""
    _check_image(qkv, bias, mask, window)
    b, rows, cols, c3 = qkv.shape
    return qkv.new_empty((b, rows, cols, c3 // 3))


@torch.library.custom_op("medseg_torch::image_attention", mutates_args=())
def _image_attention_op(qkv: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor], scale: float,
                        window: int) -> torch.Tensor:
    """K2 as a torch operator: :func:`image_attention_cuda`, which raises
    on a tensor that is not on the card."""
    return image_attention_cuda(qkv, bias, mask, scale, window)


def image_attention_backward_cuda(qkv, bias, mask, scale: float,
                                  window: int, g, bias_grad: bool = True,
                                  mask_grad: bool = True):
    """Gradients of image-layout attention by the backward kernel, on the
    current stream: ``(dqkv, dbias, dmask)`` as
    :func:`image_attention_backward` gives them, dqkv written straight in
    the (B, Rh, Rw, 3C) layout; dbias None unless *bias_grad*, dmask None
    unless *mask_grad* and there is a mask.  Raises on inputs it does not
    take or if a launch is refused."""
    _check_image(qkv, bias, mask, window)
    b, rows, cols, c3 = qkv.shape
    _check_grad("image-attention", g, (b, rows, cols, c3 // 3), qkv)
    heads, n = bias.shape[0], window * window
    mask_grad = mask_grad and mask is not None
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias) if bias_grad else None
    dmask = torch.empty_like(mask) if mask_grad else None
    with torch.cuda.device(qkv.device):
        partial, tiles = _partials(
            "image_attention", qkv.dtype, qkv.device, n,
            (b, rows, cols, c3 // 3, heads, window, int(mask is not None))) \
            if bias_grad or mask_grad else (None, 0)
        err = _grad_entry("image_attention", qkv.dtype)(
            qkv.data_ptr(), g.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
            None if partial is None else partial.data_ptr(), tiles,
            None if dbias is None else dbias.data_ptr(),
            None if dmask is None else dmask.data_ptr(),
            b, rows, cols, c3 // 3, heads, window, scale,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"image-attention backward kernel launch failed "
                           f"with CUDA error {err} for qkv "
                           f"{tuple(qkv.shape)} {qkv.dtype}")
    image_attention_backward_cuda.launches += 1
    return dqkv, dbias, dmask


#: launches of the backward kernel since the count was last set to 0
image_attention_backward_cuda.launches = 0


@torch.library.custom_op("medseg_torch::image_attention_backward",
                         mutates_args=(), device_types="cuda")
def _image_attention_backward_op(
        qkv: torch.Tensor, bias: torch.Tensor, mask: Optional[torch.Tensor],
        g: torch.Tensor, scale: float, window: int, bias_grad: bool,
        mask_grad: bool) -> List[torch.Tensor]:
    """K2's backward as a torch operator: [dqkv], then dbias if
    *bias_grad*, then dmask if *mask_grad* (only with a mask).  On the card
    :func:`image_attention_backward_cuda`; on the CPU its plain version."""
    mask_grad = mask_grad and mask is not None
    return _grads_list(image_attention_backward_cuda(
        qkv, bias, mask, scale, window, g, bias_grad, mask_grad),
        bias_grad, mask_grad)


@_image_attention_backward_op.register_kernel("cpu")
def _image_attention_backward_plain(qkv, bias, mask, g, scale, window,
                                    bias_grad, mask_grad):
    mask_grad = mask_grad and mask is not None
    return _grads_list(image_attention_backward(qkv, bias, mask, scale,
                                                window, g),
                       bias_grad, mask_grad)


@_image_attention_backward_op.register_fake
def _image_attention_backward_fake(qkv, bias, mask, g, scale, window,
                                   bias_grad, mask_grad):
    _check_image(qkv, bias, mask, window)
    mask_grad = mask_grad and mask is not None
    return _grads_list((torch.empty_like(qkv), torch.empty_like(bias),
                        None if mask is None else torch.empty_like(mask)),
                       bias_grad, mask_grad)


def _save_image_inputs(ctx, inputs, output):
    qkv, bias, mask, ctx.scale, ctx.window = inputs
    ctx.save_for_backward(qkv, bias, mask)


def _image_attention_grad(ctx, g):
    """The backward operator, asked for dbias and dmask only where they
    need a gradient."""
    qkv, bias, mask = ctx.saved_tensors
    bias_grad = ctx.needs_input_grad[1]
    mask_grad = mask is not None and ctx.needs_input_grad[2]
    grads = torch.ops.medseg_torch.image_attention_backward(
        qkv, bias, mask, g.contiguous(), ctx.scale, ctx.window, bias_grad,
        mask_grad)
    dbias = grads[1] if bias_grad else None
    dmask = grads[-1] if mask_grad else None
    return grads[0], dbias, dmask, None, None


_image_attention_op.register_fake(_image_attention_fake)
_image_attention_op.register_autograd(_image_attention_grad,
                                      setup_context=_save_image_inputs)


def fused_image_window_attention(qkv, bias, mask: Optional[torch.Tensor],
                                 scale: float, window: int,
                                 force: Optional[str] = None,
                                 train: bool = False) -> torch.Tensor:
    """Image-layout window attention, qkv (B, Rh, Rw, 3C) -> (B, Rh, Rw,
    C).
    Dispatch as :func:`window_attention_core`: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor or under ``force="torch"``;
    ``train`` changes nothing, as there."""
    if _impl(force, qkv.device) == "torch":
        return image_attention_torch(qkv, bias, mask, scale, window)
    if _straight(qkv, bias, mask):
        return image_attention_cuda(qkv, bias, mask, scale, window)
    return torch.ops.medseg_torch.image_attention(qkv, bias, mask,
                                                  float(scale), int(window))


#: the Swin blocks' switch onto the image-layout path, as in the JAX
#: package: "off" (the default: the windows-layout path through
#: window_attention_core), "on" (always) or "auto" (the no-grad bf16
#: forward on a CUDA tensor, the card's counterpart of the JAX package's
#: no-grad bf16 forward on a TPU)
_FUSED_IMAGE_MODE = "off"


def set_fused_image_mode(mode: str) -> None:
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused image mode must be 'auto', 'on' or 'off', "
                         f"got {mode!r}")
    global _FUSED_IMAGE_MODE
    _FUSED_IMAGE_MODE = mode


def use_fused_image(train: bool, dtype: torch.dtype,
                    device: torch.device) -> bool:
    """Should a SwinTransformerBlock take the image-layout path?  *dtype*
    is the compute dtype (the qkv projection's output), *device* where the
    block runs."""
    if _FUSED_IMAGE_MODE == "off":
        return False
    if _FUSED_IMAGE_MODE == "on":
        return True
    return (not train and not torch.is_grad_enabled()
            and dtype == torch.bfloat16 and device.type == "cuda")
