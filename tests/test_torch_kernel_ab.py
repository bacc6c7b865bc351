"""The parent-against-change timing tool of the port's kernels
(``medsegpretrainimagenet_tpu_torch/ops/kernel_ab.py``): what it times and
how it refuses a directory that is not a checkout.  Its timing needs the
card and is run there."""
import subprocess
import sys
from pathlib import Path

from medsegpretrainimagenet_tpu_torch.ops import kernel_ab

ROOT = Path(__file__).resolve().parent.parent


def test_shapes_are_one_forward_of_swin_unet_224():
    shapes = list(kernel_ab._shapes())
    assert len(shapes) == 7
    assert sum(calls for *_, calls in shapes) == 14
    assert sum(calls for _, _, _, _, masked, calls in shapes if masked) == 6
    assert kernel_ab.THIS == ROOT


def test_refuses_a_directory_without_the_package(tmp_path):
    run = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.ops.kernel_ab",
         str(tmp_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert run.returncode != 0
    assert "holds no medsegpretrainimagenet_tpu_torch package" in run.stderr
    assert "[ab]" not in run.stdout


def test_float32_times_the_swin_encoder_forward_of_robustness_224():
    """``--dtype float32`` times the attention calls of robustness_224's
    Swin encoder at 32 probes (chip_smoke.py's ROB_ATTENTION) under the
    float32 bar; bf16 stays the default."""
    import chip_smoke

    shapes = list(kernel_ab._shapes("float32"))
    assert kernel_ab.ROB_LEVELS == chip_smoke.ROB_ATTENTION
    assert len(shapes) == 7
    assert sum(calls for *_, calls in shapes) \
        == chip_smoke.ROB_K1_PER_FORWARD == 8
    assert sum(calls for _, _, _, _, masked, calls in shapes if masked) == 3
    batch, _, tol, _ = kernel_ab.CASES["float32"]
    assert batch == chip_smoke.ROB_PROBES == 32
    assert tol == chip_smoke.F32_TOL
    assert list(kernel_ab._shapes()) == list(kernel_ab._shapes("bfloat16"))
    run = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.ops.kernel_ab",
         str(ROOT), "--dtype", "float64"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 2 and "invalid choice" in run.stderr


#: two instances as ``cuobjdump -sass`` and ``-res-usage`` print them for
#: sm_90a: a 128-bit instruction takes two lines, the second holding only
#: the rest of its encoding
SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_116window_attentionI13__nv_bfloat16Li32EEEvPKT_S4_S4_PKfS6_PS2_iiiiiifii
\t.headerflags\t@"EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fc40000000f00 */
        /*0010*/              @!P0 BRA 0x1a0 ;                     /* 0x0000000000008947 */
                                                                   /* 0x000fea0003800000 */
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ; /* 0x0000000c0804723c */
                                                                   /* 0x000fde0000041804 */
\t\t.......
\t\tFunction : _ZN12_GLOBAL__N_115image_attentionIfLi64EEEvPKT_PKfS5_PS2_iiiiifii
        /*0000*/                   HMMA.1684.F32.TF32 R4, R8, R12, R4 ; /* 0x0000000c0804723c */
                                                                   /* 0x000fde0000041804 */
"""
USAGE = """Resource usage:
 Function _ZN12_GLOBAL__N_116window_attentionI13__nv_bfloat16Li32EEEvPKT_S4_S4_PKfS6_PS2_iiiiiifii:
  REG:72 STACK:0 SHARED:0 LOCAL:0 CONSTANT[0]:604 TEXTURE:0 SURFACE:0
"""


def test_sass_is_read_per_instance_without_addresses_or_encodings():
    """What ``[ab sass]`` and ``chip_smoke.py``'s ``[build]`` compare and
    count: each instance's instructions, opcodes and registers."""
    parsed = {kernel_ab.instance_label(symbol): code
              for symbol, code in kernel_ab.parse_sass(SASS, USAGE).items()}
    assert set(parsed) == {"window_attention<bf16, DP 32>",
                           "image_attention<f32, DP 64>"}
    code, registers = parsed["window_attention<bf16, DP 32>"]
    assert code == ["LDC R1, c[0x0][0x28]", "@!P0 BRA 0x1a0",
                    "HMMA.16816.F32.BF16 R4, R8, R12, R4"]
    assert registers == 72
    assert kernel_ab.opcodes(code) == ["LDC", "BRA", "HMMA.16816.F32.BF16"]
    assert parsed["image_attention<f32, DP 64>"] == (
        ["HMMA.1684.F32.TF32 R4, R8, R12, R4"], None)
    assert kernel_ab.instance_label("_Z3foov") == "_Z3foov"
    # the bf16-only kernels of older trees carry the same labels
    assert kernel_ab.instance_label(
        "_ZN12_GLOBAL__N_121window_attention_bf16ILi32EEEvPK13__nv_"
        "bfloat16S3_S3_PKfS5_PS1_iiiiiifii") == "window_attention<bf16, DP 32>"


def test_backward_mode_is_one_of_the_modes(tmp_path):
    """``--backward`` times the backward kernels of both trees at the
    forward's shapes; it is not taken with ``--serve``, and a directory
    without the package is refused as in the other modes."""
    run = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.ops.kernel_ab",
         str(ROOT), "--serve", "--backward"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 2 and "not allowed with" in run.stderr
    run = subprocess.run(
        [sys.executable, "-m", "medsegpretrainimagenet_tpu_torch.ops.kernel_ab",
         str(tmp_path), "--backward"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert run.returncode != 0
    assert "holds no medsegpretrainimagenet_tpu_torch package" in run.stderr


def test_backward_times_one_swin_224_train_step_in_either_dtype():
    """``--backward`` times the 14 attention calls of one swin_224_train
    step (batch 24, chip_smoke.py's [k1 bwd] and [k2 bwd]) in bf16 and in
    float32, each under its dtype's bar; the float32 forward keeps
    robustness_224's shapes."""
    import chip_smoke

    for dtype, tol in (("bfloat16", chip_smoke.BF16_TOL),
                       ("float32", chip_smoke.F32_TOL)):
        batch, _, bar, what = kernel_ab._case(dtype, backward=True)
        assert (batch, bar) == (chip_smoke.BATCH, tol) == (24, tol)
        assert "swin_224_train" in what
        assert list(kernel_ab._shapes(dtype, backward=True)) \
            == list(kernel_ab._shapes("bfloat16"))
    assert kernel_ab._case("float32")[0] == kernel_ab.ROB_PROBES


def test_backward_instances_have_labels_of_their_own():
    """The backward kernels' instances, as nvcc names them on the card
    (the file's own anonymous namespace first), are labelled apart from
    the forwards'; the partial sum keeps its symbol, which ``[build]``
    exempts from the HMMA check."""
    label = kernel_ab.instance_label
    assert label("_ZN56_GLOBAL__N__ea51cef7_23_window_attention_bwd_cu_be2f1"
                 "f0b20window_attention_bwdI13__nv_bfloat16Li32EEEvPKT_S4_S4"
                 "_S4_PKfS6_PS2_S7_S7_iiiiifiPfi") \
        == "window_attention_bwd<bf16, DP 32>"
    assert label("_ZN55_GLOBAL__N__f137b209_22_image_attention_bwd_cu_c68f1a"
                 "1219image_attention_bwdIfLi64EEEvPKT_S3_PKfS5_PS1_iiiiiifi"
                 "Pfi") == "image_attention_bwd<f32, DP 64>"
    assert label("_ZN52_GLOBAL__N__b3cab887_19_window_attention_cu_99c79937"
                 "16window_attentionIfLi64EEEvPKT_S3_S3_PKfS5_PS1_iiiiifii") \
        == "window_attention<f32, DP 64>"
    assert label("_ZN4tile12sum_partialsEPKfPfS2_iiii") \
        == "_ZN4tile12sum_partialsEPKfPfS2_iiii"


def test_chip_smoke_builds_and_checks_every_kernel_source():
    """``[build]`` wants every library of ``csrc/*.cu``: the attention
    forwards and their backwards, and the LayerNorm's, the one library
    without tensor-core instructions."""
    import chip_smoke

    sources = {p.stem for p in (ROOT / "medsegpretrainimagenet_tpu_torch"
                                / "csrc").glob("*.cu")}
    assert chip_smoke.KERNEL_LIBRARIES == sources == {
        "window_attention", "image_attention", "window_attention_bwd",
        "image_attention_bwd", "layer_norm"}
    assert chip_smoke.NO_TENSOR_CORES == {"layer_norm"}


def test_serve_times_the_model_that_chip_smoke_serves():
    """``--serve`` builds chip_smoke.py's swin_unet_224 and serves it at
    the kernels' batch."""
    import chip_smoke

    assert kernel_ab.swin_unet_224_config() == \
        chip_smoke.swin_unet_224_config()
    assert kernel_ab.BATCH == chip_smoke.BATCH
    assert kernel_ab.SERVE_IMAGES == chip_smoke.SERVE_IMAGES
