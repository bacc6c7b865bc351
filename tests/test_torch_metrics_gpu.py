"""The port's metric suite on the card: every metric's update on a card
batch agrees with the same update on the CPU (per-step values and the
epoch row within TOL), queues no host sync (sync debug mode "error") and
runs under deterministic algorithms with the same values.

Every test here is marked ``gpu`` and skips without a CUDA card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch; there,
skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_metrics_gpu.py -q
"""
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.metrics.calculator import to_host

pytestmark = pytest.mark.gpu

TOL = 1e-5
MC = "metrics.multiclass_metrics."
CASES = {
    "hd95": (("metrics.ModifiedHausdorffDistance",), "binary"),
    "auroc": (("metrics.AUROC",), "binary"),
    "average_precision": (("metrics.AveragePrecision",), "binary"),
    "covidqu_set": (("metrics.DiceIndex", "metrics.JaccardIndex",
                     "metrics.MCC", "metrics.ModifiedHausdorffDistance",
                     "metrics.AUROC"), "binary"),
    "cm_family": ((MC + "DiceIndex", MC + "JaccardIndex",
                   MC + "BalancedAccuracy", MC + "ClasswiseAccuracies",
                   MC + "ClasswiseDiceIndices", MC + "Accuracy"),
                  "multiclass"),
    "mc_auroc": ((MC + "AUROC",), "multiclass"),
    "mc_average_precision": ((MC + "AveragePrecision",), "multiclass"),
    "mc_hd95": ((MC + "ModifiedHausdorffDistance",), "multiclass"),
    "top5": ((MC + "Top5Accuracy",), "multiclass"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the test holds the card against "
                    "the CPU")
    return torch.device("cuda")


def _inputs(kind, seed=0, n=4, size=64, classes=6):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    if kind == "binary":
        mask = np.zeros((n, size, size), np.float32)
        for m in mask:
            cy, cx = rng.integers(8, size - 8, 2)
            m[(yy - cy) ** 2 + (xx - cx) ** 2 < rng.integers(16, 200)] = 1
        logits = rng.normal(0, 1.5, mask.shape) + 3 * (2 * mask - 1)
        return (1 / (1 + np.exp(-logits)))[..., None].astype(np.float32), \
            mask
    labels = np.zeros((n, size, size), np.int64)
    for lab in labels:
        for c in range(1, classes):
            cy, cx = rng.integers(8, size - 8, 2)
            lab[(yy - cy) ** 2 + (xx - cx) ** 2 < rng.integers(16, 120)] = c
    raw = rng.normal(0, 1.5, labels.shape + (classes,)) \
        + 3 * np.eye(classes)[labels]
    return (np.exp(raw) / np.exp(raw).sum(-1, keepdims=True)).astype(
        np.float32), labels


def _update(names, inputs, device, steps=2):
    calc = MetricsCalculator(ConfigDict({"metrics": {
        "metrics": names, "calculation": {"number_of_classes": 6}}}))
    state = calc.init_state(device)
    pred = torch.from_numpy(inputs[0]).to(device)
    batch = {"mask": torch.from_numpy(inputs[1]).to(device)}
    per_batch = None
    for _ in range(steps):
        state, per_batch = calc.update(state, pred, batch)
    return to_host(per_batch), calc.finalize_epoch(state)


def _assert_close(got, want):
    (step, row), (step_want, row_want) = got, want
    assert step.keys() == step_want.keys() and row.keys() == row_want.keys()
    for key in step_want:
        np.testing.assert_allclose(step[key], step_want[key], rtol=TOL,
                                   atol=TOL, err_msg=key)
    for key in row_want:
        np.testing.assert_allclose(row[key], row_want[key], rtol=TOL,
                                   atol=TOL, err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_update_on_the_card_matches_the_cpu(cuda_device, case):
    names, kind = CASES[case]
    inputs = _inputs(kind)
    _assert_close(_update(names, inputs, cuda_device),
                  _update(names, inputs, "cpu"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_update_queues_no_host_sync(cuda_device, case):
    names, kind = CASES[case]
    inputs = _inputs(kind, seed=1)
    calc = MetricsCalculator(ConfigDict({"metrics": {
        "metrics": names, "calculation": {"number_of_classes": 6}}}))
    state = calc.init_state(cuda_device)
    pred = torch.from_numpy(inputs[0]).to(cuda_device)
    batch = {"mask": torch.from_numpy(inputs[1]).to(cuda_device)}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, _ = calc.update(state, pred, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(list(calc.finalize_epoch(state).values())).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_update_under_deterministic_algorithms(cuda_device, case):
    names, kind = CASES[case]
    inputs = _inputs(kind, seed=2)
    default = _update(names, inputs, cuda_device)
    torch.use_deterministic_algorithms(True)
    try:
        deterministic = _update(names, inputs, cuda_device)
    finally:
        torch.use_deterministic_algorithms(False)
    _assert_close(deterministic, default)
