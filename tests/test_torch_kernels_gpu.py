"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (window attention, windows layout) and K2 (image layout), forward and
backward (``window_attention_backward_cuda``, ``image_attention_backward_cuda``
against ``window_attention_backward``, ``image_attention_backward``).

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.models.swin import _shift_attn_mask
from medsegpretrainimagenet_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.gpu

SCALE = 32 ** -0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: (N, D) at the edges of what the kernels take, swin_unet_224's, one with
#: D not a multiple of 8 (the bf16 instances' element-wise loads) and one
#: with D not a multiple of 4 (the float32 instances' as well), each on a
#: 2x2 grid of windows with 3 heads; the pair counts (401 windows, or
#: 101 images) are prime, so the last block of the bf16 kernels' grid holds
#: fewer pairs than the others.  Then level 1 of swin_unet_224, whose 4x4
#: grid of windows (16 mask rows) the model runs.
#: K1: (N, D, windows per side of the grid, windows under W-MSA, heads)
K1_SHAPES = pytest.mark.parametrize(
    "n,d,grid,windows,heads",
    [(16, 8, 2, 401, 3), (49, 32, 2, 401, 3), (64, 64, 2, 401, 3),
     (25, 12, 2, 401, 3), (49, 30, 2, 401, 3), (49, 32, 4, 64, 3)],
    ids=["16x8", "49x32", "64x64", "25x12", "49x30", "level1"])
#: K2: (N, D, windows per side of the grid, images, heads)
K2_SHAPES = pytest.mark.parametrize(
    "n,d,grid,batch,heads",
    [(16, 8, 2, 101, 3), (49, 32, 2, 101, 3), (64, 64, 2, 101, 3),
     (25, 12, 2, 101, 3), (49, 30, 2, 101, 3), (49, 32, 4, 2, 6)],
    ids=["16x8", "49x32", "64x64", "25x12", "49x30", "level1"])
#: bars on the max and the mean |kernel - plain|.  Both instances sum in
#: another order than the plain version: bf16 reads a mean of about 1e-7 on
#: swin_unet_224's shapes, float32 (split TF32) a max of about 4e-6 and a
#: mean of about 1e-7; one that drops its bias, or takes another head's
#: bias or another window's mask, reads 3e-3 or more (chip_smoke.py
#: measures both), under the max bar all the same.
DTYPES = pytest.mark.parametrize("dtype,tol,mean_tol",
                                 [(torch.bfloat16, 0.05, 1e-5),
                                  (torch.float32, 1e-4, 1e-6)],
                                 ids=["bf16", "f32"])
MASKED = pytest.mark.parametrize("masked", [False, True],
                                 ids=["w_msa", "sw_msa"])


def _mask(window, grid, device):
    """The shift mask of a grid x grid grid of windows: (grid², N, N)."""
    return torch.from_numpy(_shift_attn_mask(
        (grid * window, grid * window), window, window // 2)).to(device)


def _inputs(dtype, masked, device, n=49, d=32, grid=2, windows=401,
            heads=3, seed=0):
    """q, k, v, bias and mask; under SW-MSA *windows* is rounded up to
    whole images of the grid."""
    window = int(round(n ** 0.5))
    if masked:
        windows = -(-windows // grid ** 2) * grid ** 2
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(windows, heads, n, d, generator=g)
               .to(device, dtype) for _ in range(3))
    bias = (0.02 * torch.randn(heads, n, n, generator=g)).to(device)
    return q, k, v, bias, _mask(window, grid, device) if masked else None


def _assert_close(out, ref, tol, mean_tol):
    diff = (out.float() - ref.float()).abs()
    assert diff.max().item() < tol
    assert diff.mean().item() < mean_tol


@DTYPES
@MASKED
@K1_SHAPES
def test_window_attention_kernel_matches_plain(cuda_device, dtype, tol,
                                               mean_tol, masked, n, d, grid,
                                               windows, heads):
    args = _inputs(dtype, masked, cuda_device, n, d, grid, windows, heads)
    wa.window_attention_cuda.launches = 0
    out = wa.window_attention_core(*args, d ** -0.5)
    ref = wa.window_attention_core(*args, d ** -0.5, force="torch")
    torch.cuda.synchronize()
    assert wa.window_attention_cuda.launches == 1
    assert out.dtype == dtype and out.shape == ref.shape
    _assert_close(out, ref, tol, mean_tol)


def _off_by_one_float(t):
    """A contiguous copy of *t* one element (a float, or a bf16) past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def test_f32_kernels_take_operands_that_are_not_16_byte_aligned(
        cuda_device):
    """The float32 instances load and store such operands one element at a
    time; held under the float32 bars."""
    q, k, v, bias, mask = _inputs(torch.float32, True, cuda_device, seed=2)
    out = wa.window_attention_cuda(*map(_off_by_one_float, (q, k, v)), bias,
                                   mask, SCALE)
    ref = wa.window_attention_core(q, k, v, bias, mask, SCALE, force="torch")
    _assert_close(out, ref, 1e-4, 1e-6)
    qkv, bias, mask = _image_inputs(torch.float32, True, cuda_device, seed=2)
    out = wa.image_attention_cuda(_off_by_one_float(qkv), bias, mask, SCALE,
                                  7)
    ref = wa.image_attention_torch(qkv, bias, mask, SCALE, 7)
    _assert_close(out, ref, 1e-4, 1e-6)


def test_window_attention_kernel_backward_matches_autograd(cuda_device):
    args = _inputs(torch.float32, True, cuda_device, seed=1)
    g = torch.randn(args[0].shape, device=cuda_device)
    grads = []
    for force in (None, "torch"):
        leaves = [t.clone().requires_grad_() for t in args]
        (wa.window_attention_core(*leaves, SCALE, force=force) * g) \
            .sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() < 1e-3


#: backward shapes: swin_unet_224's four levels at two images (N 49, D 32;
#: windows per side 8, 4, 2, 1; 3, 6, 12, 24 heads), then the edges: N 16
#: and 64, D 8, 24 and 64, and two D that the 16-byte loads do not take
#: (element-wise in bf16 and in float32); (N, D, windows per side,
#: windows, heads, shifted)
BWD_K1_SHAPES = [pytest.param(*shape, id=name) for name, shape in (
    ("level0-w_msa", (49, 32, 8, 128, 3, False)),
    ("level0-sw_msa", (49, 32, 8, 128, 3, True)),
    ("level1-w_msa", (49, 32, 4, 32, 6, False)),
    ("level1-sw_msa", (49, 32, 4, 32, 6, True)),
    ("level2-w_msa", (49, 32, 2, 8, 12, False)),
    ("level2-sw_msa", (49, 32, 2, 8, 12, True)),
    ("level3-w_msa", (49, 32, 1, 2, 24, False)),
    ("16x8", (16, 8, 2, 101, 3, True)), ("64x64", (64, 64, 2, 101, 3, True)),
    ("49x24", (49, 24, 2, 101, 3, True)), ("25x12", (25, 12, 2, 101, 3, True)),
    ("49x30", (49, 30, 2, 101, 3, False)))]


def _hold_grads(got, want, tol, mean_tol, names):
    """The gradients of a backward kernel against its plain version's:
    the inputs' under the dtype's bars, dbias and dmask (float32 sums over
    windows) relative to their largest magnitude under the float32 bars."""
    for name, a, b in zip(names, got, want):
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("dbias", "dmask"):
            diff = (a - b).abs() / b.abs().max()
            assert diff.max().item() < 1e-4, (name, diff.max().item())
            assert diff.mean().item() < 1e-6, (name, diff.mean().item())
        else:
            _assert_close(a, b, tol, mean_tol)


@DTYPES
@pytest.mark.parametrize("n,d,grid,windows,heads,masked", BWD_K1_SHAPES)
def test_window_attention_backward_kernel_matches_plain(
        cuda_device, dtype, tol, mean_tol, n, d, grid, windows, heads,
        masked):
    """dq, dk, dv, dbias and (SW-MSA) dmask; the same inputs give bit-equal
    gradients on a second launch (no float atomics)."""
    q, k, v, bias, mask = _inputs(dtype, masked, cuda_device, n, d, grid,
                                  windows, heads, seed=3)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)) \
        .to(cuda_device, dtype)
    wa.window_attention_backward_cuda.launches = 0
    got = wa.window_attention_backward_cuda(q, k, v, bias, mask, d ** -0.5, g)
    again = wa.window_attention_backward_cuda(q, k, v, bias, mask, d ** -0.5,
                                              g)
    want = wa.window_attention_backward(q, k, v, bias, mask, d ** -0.5, g)
    torch.cuda.synchronize()
    assert wa.window_attention_backward_cuda.launches == 2
    _hold_grads(got, want, tol, mean_tol, ("dq", "dk", "dv", "dbias",
                                          "dmask"))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["window_attention", "image_attention"])
def test_float32_backward_keeps_eight_warps_per_sm(cuda_device, kernel):
    """The float32 backward at swin_unet_224's shapes (N 49, D 32, masked)
    holds two blocks of four warps on an SM: at level 1's SW-MSA call (16
    windows x 6 heads at batch 24) its grid, and so its partial-tile
    count, takes at least twice the 96 groups."""
    smem, blocks = wa.backward_residency(kernel, torch.float32, 49, 32, True)
    assert 4 * blocks >= 8, (smem, blocks)
    shape = (24 * 16, 6, 49, 32, 16, 1) if kernel == "window_attention" \
        else (24, 28, 28, 6 * 32, 6, 7, 1)
    tiles = wa._grad_entry(kernel, torch.float32, tiles=True)(*shape)
    assert tiles >= 2 * 96, tiles


@pytest.mark.parametrize("kernel", ["window_attention", "image_attention"])
def test_bfloat16_backward_keeps_twelve_warps_per_sm(cuda_device, kernel):
    """The bf16 backward at swin_unet_224's shapes (N 49, D 32, masked)
    holds three blocks of four warps on an SM: at level 1's SW-MSA call
    (16 windows x 6 heads at batch 24) its grid, and so its partial-tile
    count, takes at least three times the 96 groups."""
    smem, blocks = wa.backward_residency(kernel, torch.bfloat16, 49, 32,
                                         True)
    assert 4 * blocks >= 12, (smem, blocks)
    shape = (24 * 16, 6, 49, 32, 16, 1) if kernel == "window_attention" \
        else (24, 28, 28, 6 * 32, 6, 7, 1)
    tiles = wa._grad_entry(kernel, torch.bfloat16, tiles=True)(*shape)
    assert tiles >= 3 * 96, tiles


def test_bfloat16_backward_takes_operands_that_are_not_16_byte_aligned(
        cuda_device):
    """Operands one element past a 16-byte boundary cannot go through the
    tensor maps: the bf16 backward copies them element by element, held
    under the bf16 bars and bit-equal on a second launch."""
    q, k, v, bias, mask = _inputs(torch.bfloat16, True, cuda_device, seed=8)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)) \
        .to(cuda_device, torch.bfloat16)
    shifted = [_off_by_one_float(t) for t in (q, k, v, g)]
    got = wa.window_attention_backward_cuda(*shifted[:3], bias, mask, SCALE,
                                            shifted[3])
    again = wa.window_attention_backward_cuda(*shifted[:3], bias, mask,
                                              SCALE, shifted[3])
    want = wa.window_attention_backward(q, k, v, bias, mask, SCALE, g)
    torch.cuda.synchronize()
    _hold_grads(got, want, 0.05, 1e-5, ("dq", "dk", "dv", "dbias", "dmask"))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qkv, bias, mask = _image_inputs(torch.bfloat16, True, cuda_device,
                                    seed=8)
    g = torch.randn(qkv.shape[:3] + (qkv.shape[3] // 3,),
                    generator=torch.Generator().manual_seed(9)) \
        .to(cuda_device, torch.bfloat16)
    got = wa.image_attention_backward_cuda(_off_by_one_float(qkv), bias,
                                           mask, SCALE, 7,
                                           _off_by_one_float(g))
    want = wa.image_attention_backward(qkv, bias, mask, SCALE, 7, g)
    torch.cuda.synchronize()
    _hold_grads(got, want, 0.05, 1e-5, ("dqkv", "dbias", "dmask"))


def test_backward_kernels_give_only_the_table_gradients_asked_for(
        cuda_device):
    q, k, v, bias, mask = _inputs(torch.float32, True, cuda_device, seed=5)
    g = torch.randn_like(q)
    want = wa.window_attention_backward(q, k, v, bias, mask, SCALE, g)
    for bias_grad, mask_grad in ((False, False), (True, False),
                                 (False, True)):
        got = wa.window_attention_backward_cuda(q, k, v, bias, mask, SCALE, g,
                                                bias_grad, mask_grad)
        assert (got[3] is None) != bias_grad and (got[4] is None) != mask_grad
        _hold_grads(got, [w if t is not None else None
                          for w, t in zip(want, got)], 1e-4, 1e-6,
                    ("dq", "dk", "dv", "dbias", "dmask"))


@pytest.mark.parametrize("path", ["k1", "k2"])
def test_operator_autograd_launches_the_backward_kernel(cuda_device, path,
                                                        monkeypatch):
    """Under autograd the registered operators' gradient is the backward
    kernel, one launch per call; the plain backward versions, patched to
    raise, are never reached.  The gradients equal plain autograd's within
    0.05 of their largest value (bf16)."""
    if path == "k1":
        args = _inputs(torch.bfloat16, True, cuda_device, seed=6)
        counter = wa.window_attention_backward_cuda

        def forward(*leaves, force=None):
            return wa.window_attention_core(*leaves, SCALE, force=force)
    else:
        args = _image_inputs(torch.bfloat16, True, cuda_device, seed=6)
        counter = wa.image_attention_backward_cuda

        def forward(*leaves, force=None):
            return wa.fused_image_window_attention(*leaves, SCALE, 7,
                                                   force=force)
    ref = [t.clone().requires_grad_() for t in args]
    out = forward(*ref, force="torch")
    g = torch.randn_like(out)
    (out * g).sum().backward()
    for name in ("window_attention_backward", "image_attention_backward"):
        monkeypatch.setattr(wa, name, _raises)
    leaves = [t.clone().requires_grad_() for t in args]
    wa.window_attention_backward_cuda.launches = 0
    wa.image_attention_backward_cuda.launches = 0
    (forward(*leaves) * g).sum().backward()
    torch.cuda.synchronize()
    assert counter.launches == 1
    assert wa.window_attention_backward_cuda.launches \
        + wa.image_attention_backward_cuda.launches == 1
    for a, b in zip(leaves, ref):
        rel = ((a.grad.float() - b.grad.float()).abs().max()
               / b.grad.float().abs().max()).item()
        assert rel < 0.05, rel


def _raises(*args, **kwargs):
    raise AssertionError("the plain backward ran on the card's path")


def test_backward_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v, bias, mask = _inputs(torch.float32, True, cuda_device)
    g = torch.randn_like(q)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        wa.window_attention_backward_cuda(q.double(), k.double(), v.double(),
                                          bias, mask, SCALE, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        wa.window_attention_backward_cuda(q, k, v, bias, mask, SCALE,
                                          g.transpose(2, 3).contiguous()
                                          .transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        wa.window_attention_backward_cuda(q.transpose(2, 3).contiguous()
                                          .transpose(2, 3), k, v, bias, mask,
                                          SCALE, g)
    with pytest.raises(ValueError, match="g of"):
        wa.window_attention_backward_cuda(q, k, v, bias, mask, SCALE,
                                          g.bfloat16())
    big = torch.zeros(2, 1, 65, 8, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 64"):
        wa.window_attention_backward_cuda(
            big, big, big, torch.zeros(1, 65, 65, device=cuda_device), None,
            SCALE, big)
    qkv, bias, mask = _image_inputs(torch.float32, True, cuda_device)
    g = torch.randn(2, 28, 28, 192, device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        wa.image_attention_backward_cuda(qkv.double(), bias, mask, SCALE, 7,
                                         g.double())
    with pytest.raises(ValueError, match="contiguous"):
        wa.image_attention_backward_cuda(qkv, bias, mask, SCALE, 7,
                                         g.transpose(1, 2))
    with pytest.raises(ValueError, match="N <= 64"):
        wa.image_attention_backward_cuda(
            qkv[:, :27, :27].contiguous(),
            torch.zeros(6, 81, 81, device=cuda_device), None, SCALE, 9,
            g[:, :27, :27].contiguous())


def test_window_attention_kernel_refuses_large_windows(cuda_device):
    q = torch.zeros(2, 1, 65, 8, device=cuda_device)
    bias = torch.zeros(1, 65, 65, device=cuda_device)
    with pytest.raises(ValueError, match="N <= 64"):
        wa.window_attention_cuda(q, q, q, bias, None, SCALE)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(2, 1, 8, 16, device=cuda_device)[..., ::2]
        wa.window_attention_cuda(x, x, x, torch.zeros(
            1, 8, 8, device=cuda_device), None, SCALE)


def _image_inputs(dtype, masked, device, batch=2, res=28, heads=6, d=32,
                  window=7, seed=0):
    """Level 1 of swin_unet_224 (R = 28, C = 192, 6 heads) by default."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(batch, res, res, 3 * d * heads, generator=g) \
        .to(device, dtype)
    n = window * window
    bias = (0.02 * torch.randn(heads, n, n, generator=g)).to(device)
    mask = torch.from_numpy(_shift_attn_mask(
        (res, res), window, window // 2)).to(device) if masked else None
    return qkv, bias, mask


@DTYPES
@MASKED
@K2_SHAPES
def test_image_attention_kernel_matches_plain(cuda_device, dtype, tol,
                                              mean_tol, masked, n, d, grid,
                                              batch, heads):
    window = int(round(n ** 0.5))
    res = grid * window
    args = _image_inputs(dtype, masked, cuda_device, batch=batch, res=res,
                         heads=heads, d=d, window=window)
    wa.image_attention_cuda.launches = 0
    out = wa.fused_image_window_attention(*args, d ** -0.5, window)
    ref = wa.fused_image_window_attention(*args, d ** -0.5, window,
                                          force="torch")
    torch.cuda.synchronize()
    assert wa.image_attention_cuda.launches == 1
    assert out.dtype == dtype and out.shape == ref.shape \
        == (batch, res, res, heads * d)
    _assert_close(out, ref, tol, mean_tol)


def test_image_attention_kernel_backward_matches_autograd(cuda_device):
    args = _image_inputs(torch.float32, True, cuda_device, seed=1)
    g = torch.randn(2, 28, 28, 192, device=cuda_device)
    grads = []
    for force in (None, "torch"):
        leaves = [t.clone().requires_grad_() for t in args]
        (wa.fused_image_window_attention(*leaves, SCALE, 7, force=force)
         * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() < 1e-3


#: K2's backward: swin_unet_224's four levels at two images, level 0's
#: bands of data x spatial 1 x 2 and 1 x 4 (28 x 56 and 14 x 56 with the
#: last band's rows of the shift mask), and the edges; (N, D, rows, cols,
#: batch, heads, shifted)
BWD_K2_SHAPES = [pytest.param(*shape, id=name) for name, shape in (
    ("level0-w_msa", (49, 32, 56, 56, 2, 3, False)),
    ("level0-sw_msa", (49, 32, 56, 56, 2, 3, True)),
    ("level1-w_msa", (49, 32, 28, 28, 2, 6, False)),
    ("level1-sw_msa", (49, 32, 28, 28, 2, 6, True)),
    ("level2-w_msa", (49, 32, 14, 14, 2, 12, False)),
    ("level2-sw_msa", (49, 32, 14, 14, 2, 12, True)),
    ("level3-w_msa", (49, 32, 7, 7, 2, 24, False)),
    ("band28x56", (49, 32, 28, 56, 8, 3, True)),
    ("band14x56", (49, 32, 14, 56, 8, 3, True)),
    ("16x8", (16, 8, 8, 8, 101, 3, True)),
    ("64x64", (64, 64, 16, 16, 101, 3, True)),
    ("49x24", (49, 24, 14, 14, 101, 3, True)),
    ("25x12", (25, 12, 10, 10, 101, 3, True)),
    ("49x30", (49, 30, 14, 14, 101, 3, False)))]


@DTYPES
@pytest.mark.parametrize("n,d,rows,cols,batch,heads,masked", BWD_K2_SHAPES)
def test_image_attention_backward_kernel_matches_plain(
        cuda_device, dtype, tol, mean_tol, n, d, rows, cols, batch, heads,
        masked):
    """dqkv, dbias and (SW-MSA) dmask, a band's with the last band's mask
    rows; bit-equal on a second launch."""
    window = int(round(n ** 0.5))
    gen = torch.Generator().manual_seed(7)
    qkv = torch.randn(batch, rows, cols, 3 * heads * d, generator=gen) \
        .to(cuda_device, dtype)
    g = torch.randn(batch, rows, cols, heads * d, generator=gen) \
        .to(cuda_device, dtype)
    bias = (0.02 * torch.randn(heads, n, n, generator=gen)).to(cuda_device)
    mask = None
    if masked:
        whole = _shift_attn_mask((cols, cols), window, window // 2)
        mask = torch.from_numpy(
            whole[len(whole) - (rows // window) * (cols // window):].copy()) \
            .to(cuda_device)
    wa.image_attention_backward_cuda.launches = 0
    got = wa.image_attention_backward_cuda(qkv, bias, mask, d ** -0.5,
                                           window, g)
    again = wa.image_attention_backward_cuda(qkv, bias, mask, d ** -0.5,
                                             window, g)
    want = wa.image_attention_backward(qkv, bias, mask, d ** -0.5, window, g)
    torch.cuda.synchronize()
    assert wa.image_attention_backward_cuda.launches == 2
    _hold_grads(got, want, tol, mean_tol, ("dqkv", "dbias", "dmask"))
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def test_image_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    qkv, bias, mask = _image_inputs(torch.float32, True, cuda_device)
    with pytest.raises(ValueError, match="divide by the window"):
        wa.image_attention_cuda(qkv[:, :27, :27].contiguous(), bias, None,
                                SCALE, 7)
    with pytest.raises(ValueError, match="divide by the window"):
        wa.image_attention_cuda(qkv[:, :28, :27].contiguous(), bias, None,
                                SCALE, 7)
    with pytest.raises(ValueError, match="mask must be"):
        wa.image_attention_cuda(qkv, bias, mask[:4], SCALE, 7)
    with pytest.raises(ValueError, match="N <= 64"):
        wa.image_attention_cuda(qkv[:, :27, :27].contiguous(), torch.zeros(
            6, 81, 81, device=cuda_device), None, SCALE, 9)
    with pytest.raises(ValueError, match="contiguous"):
        wa.image_attention_cuda(qkv.transpose(1, 2), bias, mask, SCALE, 7)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        wa.image_attention_cuda(qkv.half(), bias, mask, SCALE, 7)
