"""The cycle counters of the float32 attention backward
(``medsegpretrainimagenet_tpu_torch/ops/bwd_clocks.py``): they are put
into a copy of ``csrc/attention_tile_bwd.cuh`` at anchors in
``grad_pairs_f32``'s walk, which must all be there, once.  Building and
reading them needs the card."""
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
