"""The cycle counters of the attention backward
(``medsegpretrainimagenet_tpu_torch/ops/bwd_clocks.py``): they are put
into a copy of ``csrc/attention_tile_bwd.cuh`` at anchors in the walk of
``grad_pairs_f32`` (float32) and ``grad_pairs_bf16`` (bf16), which must
all be there, once.  Building and reading them needs the card."""
import pytest

from medsegpretrainimagenet_tpu_torch.ops import _build, bwd_clocks

HEADER = (_build.CSRC / "attention_tile_bwd.cuh").read_text()


def test_every_anchor_is_in_the_float32_body_once():
    body = HEADER[HEADER.index("void grad_pairs_f32("):]
    for anchor, _ in bwd_clocks._MARKS:
        assert body.count(anchor) == 1, anchor
    out = bwd_clocks.instrument(HEADER)
    assert out.count("clock64()") == 8
    assert out.count("atomicAdd(&bwd_clocks[") == 2
    assert "__device__ unsigned long long bwd_clocks[8];" in out
    assert len(bwd_clocks.PHASES) == 7


@pytest.mark.parametrize("anchor", [a for a, _ in bwd_clocks._MARKS],
                         ids=[f"mark{i}" for i in range(len(
                             bwd_clocks._MARKS))])
def test_a_changed_body_is_refused(anchor):
    with pytest.raises(ValueError, match="not found"):
        bwd_clocks.instrument(HEADER.replace(anchor, anchor.upper()))


def test_every_anchor_is_in_the_bf16_body_once():
    body = HEADER[HEADER.index("void grad_pairs_bf16("):]
    body = body[:body.index("\n}\n")]
    assert bwd_clocks.body_of(HEADER, "bfloat16") is bwd_clocks.BF16
    for anchor, _ in bwd_clocks.BF16.marks:
        assert body.count(anchor) == 1, anchor
    out = bwd_clocks.instrument(HEADER, "bfloat16")
    k = len(bwd_clocks.BF16.phases)
    assert out.count("clock64()") == k + 1
    assert out.count("atomicAdd(&bwd_clocks[") == 2
    assert f"__device__ unsigned long long bwd_clocks[{k + 1}];" in out
    # the float32 body is left as it was
    f32 = out[out.index("void grad_pairs_f32("):]
    assert "clock64()" not in f32[:f32.index("\n}\n")]


@pytest.mark.parametrize("anchor", [a for a, _ in bwd_clocks.BF16.marks],
                         ids=[f"mark{i}" for i in range(len(
                             bwd_clocks.BF16.marks))])
def test_a_changed_bf16_body_is_refused(anchor):
    with pytest.raises(ValueError, match="not found"):
        bwd_clocks.instrument(HEADER.replace(anchor, anchor.upper()),
                              "bfloat16")


def test_the_bf16_body_before_it_is_read_by_its_own_anchors():
    """A checkout with the mma.sync bf16 body (``tile::grad_pairs``) is
    instrumented by BF16_MMA_SYNC: its walk, written here as it reads."""
    walk = "".join(anchor for anchor, _ in bwd_clocks.BF16_MMA_SYNC.marks)
    header = ("namespace tile {\nvoid grad_pairs(int count) {\n"
              + bwd_clocks.BF16_MMA_SYNC.loop + walk + "  }\n  return;\n}\n")
    assert bwd_clocks.body_of(header, "bfloat16") is \
        bwd_clocks.BF16_MMA_SYNC
    out = bwd_clocks.instrument(header, "bfloat16")
    assert out.count("clock64()") == len(bwd_clocks.BF16_MMA_SYNC.phases) + 1
