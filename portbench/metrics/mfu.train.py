"""``mfu.train``: model FLOPs of a training step (the forward and both
backward products, never a recomputation) over the untraced window's
time a step and the chips' bf16 peak, in %."""


def read(record):
    if record is None or record.kind != "train" or not record.trace.device:
        return None
    return 100.0 * record.flops_per_step / record.wall_step_s \
        / (record.peak_flops * record.chips)
