"""``layout_copy_ms.train``: device ms a training step in the copies,
permutes, rolls, transposes and concatenations of the model layer, by
kernel-name group."""
from portbench.groups import LAYOUT, group_of


def read(record):
    if record is None or record.kind != "train" or not record.trace.device:
        return None
    spent = sum(k.dur for k in record.trace.kernels()
                if group_of(k.name, LAYOUT))
    return 1e3 * spent / record.steps if spent > 0 else None
