"""The plain reference against the port at small sizes on the CPU, both
configurations, training and evaluation, and the data-parallel training
on two gloo ranks: the harness's own sessions with the program in
float32, whose readings must be rounding alone."""
import time

import pytest
import torch

from portbench import harness, spec
from portbench.tests.cells import data_parallel_cell, run_ranks, small_cell

CASES = ["swin_unet_224.train_b256", "unet_256.train_b32",
         "swin_unet_224.eval_b128"]


def run(cell, seed=2 ** 31 + 11, faults=()):
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.2, trace=False,
                          device=torch.device("cpu"),
                          started=time.perf_counter(), faults=faults)
    return spec.load_module("entries", cell.workload["entry"]).run(ctx)


@pytest.mark.parametrize("name", CASES)
def test_reference_agrees_with_the_port(name):
    outcome = run(small_cell(name))
    assert outcome.numbers, outcome
    for key, value in outcome.numbers.items():
        assert value < 1e-4, (key, value)


def test_stochastic_depth_draws_agree():
    # a drop-path mask that differs from the port's moves the loss by far
    # more than rounding: the Swin cell draws at rate 0.2
    cell = small_cell("swin_unet_224.train_b256")
    assert cell.config["tree"]["model"]["segmentation.models.UNet"][
        "architecture"]["stochastic depth rate"] == 0.2
    numbers = run(cell, seed=5).numbers
    assert numbers["loss"] < 1e-5


def test_reference_agrees_with_the_port_on_two_ranks():
    # the global step of two ranks against the one-card reference of the
    # whole global batch; every rank's model is rank 0's to the bit
    line = run_ranks(data_parallel_cell())
    numbers = {name: value for name, value, _ in line["compared"]}
    assert set(numbers) == {"loss", "grad", "change", "stats", "replicas"}
    for key, value in numbers.items():
        assert value < 1e-4, (key, value)
    assert numbers["replicas"] == 0.0
    assert line["correct"] is True and line["device"]["count"] == 2
