"""``mfu.eval``: forward FLOPs of an evaluation step over the untraced
window's time a step and the card's bf16 peak, in %."""


def read(record):
    if record is None or record.kind != "eval" or not record.trace.device:
        return None
    return 100.0 * record.flops_per_step / record.wall_step_s \
        / (record.peak_flops * record.chips)
