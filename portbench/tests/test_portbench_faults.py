"""``correct`` comes out false for every fault a cell can have, planted
under the timed path while the rest of a run goes on (the look for a card
skipped, small sizes on the CPU; the four-card cell on two gloo ranks),
and for the control: the reference in float8 put in the program's
place."""
import time

import pytest
import torch

from portbench import control, harness, spec
from portbench.check import judge
from portbench.tests.cells import data_parallel_cell, run_ranks, small_cell

BENCH = spec.load_benchmark()
TRAIN = ["swin_unet_224.train_b256", "unet_256.train_b32"]


def line(cell, faults=(), seed=2 ** 33 + 3):
    ctx = harness.Context(cell=cell, seed=seed, seconds=0.2, trace=False,
                          device=torch.device("cpu"),
                          started=time.perf_counter(), faults=faults)
    return harness.run_cell(ctx, BENCH)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_fail(name, fault):
    assert line(small_cell(name), (fault,))["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_sound_training_run_passes(name):
    assert line(small_cell(name))["correct"] is True


@pytest.mark.parametrize("fault", ["no_exchange", "local_stats",
                                   "half_batch", "unchanged"])
def test_data_parallel_faults_fail(fault):
    line = run_ranks(data_parallel_cell(), faults=(fault,))
    assert line["correct"] is False


def test_altered_answer_fails():
    cell = small_cell("swin_unet_224.eval_b128")
    assert line(cell)["correct"] is True
    assert line(cell, ("altered_answer",))["correct"] is False


@pytest.mark.parametrize("name", TRAIN + ["swin_unet_224.eval_b128"])
def test_control_fails(name):
    cell = small_cell(name, batch=8)
    leaves = control.leaves_of(cell, torch.device("cpu"))
    numbers = control.control_numbers(cell, 2 ** 31 + 7,
                                      torch.device("cpu"), leaves)
    assert judge(numbers, cell.limits)[0] is False
