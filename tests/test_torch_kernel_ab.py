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
