"""``attn_roofline.eval``: K1's forward bound from shapes over the device
time of K1's forward kernel in the trace, in %."""
from portbench.groups import group_of


def read(record):
    if record is None or record.kind != "eval" \
            or "forward" not in record.attention_bound_s:
        return None
    spent = sum(k.dur for k in record.trace.kernels()
                if group_of(k.name, ("window_attention",))
                and not group_of(k.name, ("bwd",)))
    if spent <= 0:
        return None
    return 100.0 * record.attention_bound_s["forward"] * record.steps / spent
