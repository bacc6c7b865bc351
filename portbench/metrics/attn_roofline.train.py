"""``attn_roofline.train``: K1's forward and backward bound from shapes
(``portbench/bounds.py``) over the device time of K1's kernels in the
trace, found by name, in % (the card's power limit is in the record)."""
from portbench.groups import K1, group_of


def read(record):
    if record is None or record.kind != "train" \
            or "backward" not in record.attention_bound_s:
        return None
    spent = sum(k.dur for k in record.trace.kernels()
                if group_of(k.name, K1))
    if spent <= 0:
        return None
    bound = record.attention_bound_s["forward"] \
        + record.attention_bound_s["backward"]
    return 100.0 * bound * record.steps / spent
