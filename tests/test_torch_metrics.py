"""The port's confusion-matrix metric family against the JAX package's:
the same predictions and targets (NaN targets, several thresholds, the
multilabel CM, empty classes) through both MetricsCalculators give the same
per-step counts and derived values and the same epoch row, within 1e-6.
The rest of the suite is held in tests/test_torch_metrics_suite.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator

TOL = 1e-6
FAMILY = ("metrics.DiceIndex", "metrics.JaccardIndex", "metrics.Accuracy",
          "metrics.BalancedAccuracy", "metrics.Sensitivity",
          "metrics.Specificity", "metrics.Precision", "metrics.MCC",
          "metrics.TverskyIndex", "metrics.ConfusionMatrix")


class _Named:
    name = "dice_loss"


def _config(calculation, names=FAMILY):
    return {"metrics": {"metrics": tuple(names),
                        "calculation": dict(calculation)}}


def _batches(seed, n, shape, nan=False, empty=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pred = rng.random(shape).astype(np.float32)
        mask = (rng.random(shape[:-1]) < 0.3).astype(np.float32)
        if nan:
            mask[rng.random(mask.shape) < 0.1] = np.nan
        if empty and i == 0:  # a step with no positives and no predictions
            mask[:] = 0
            pred[:] = 0
        out.append((pred, mask))
    return out


def _run_both(calculation, batches, names=FAMILY):
    port = MetricsCalculator(ConfigDict(_config(calculation, names)),
                             loss=_Named())
    ref = JaxCalculator(JaxConfigDict(_config(calculation, names)),
                        loss=_Named())
    state, ref_state = port.init_state("cpu"), ref.init_state()
    for step, (pred, mask) in enumerate(batches):
        loss = 0.1 * (step + 1)
        state, per_batch = port.update(
            state, torch.from_numpy(pred), {"mask": torch.from_numpy(mask)},
            loss_value=torch.tensor(loss))
        ref_state, ref_batch = ref.update(
            ref_state, jnp.asarray(pred), {"mask": jnp.asarray(mask)},
            loss_value=jnp.asarray(loss, jnp.float32))
        assert set(per_batch) == set(ref_batch)
        for key, value in per_batch.items():
            assert isinstance(value, torch.Tensor)
            np.testing.assert_allclose(value.numpy(),
                                       np.asarray(ref_batch[key]), rtol=TOL,
                                       atol=TOL, err_msg=key)
        got = port.batch_values(per_batch)
        want = ref.batch_values(ref_batch)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=TOL,
                                       atol=TOL, err_msg=key)
    return port.finalize_epoch(state), ref.finalize_epoch(ref_state)


@pytest.mark.parametrize("case", ["plain", "nan_targets", "empty_step",
                                  "two_thresholds"])
def test_binary_family_matches_jax(case):
    calculation = {"thresholds": (0.3, 0.5)} if case == "two_thresholds" \
        else {"eps": 0.5, "weight_of_fps": 0.7, "weight_of_fns": 1.3,
              "name": "tversky_07"}
    batches = _batches(1, 3, (2, 8, 8, 1), nan=case == "nan_targets",
                       empty=case == "empty_step")
    got, want = _run_both(calculation, batches)
    assert got.keys() == want.keys()
    assert "metrics/dice_index_threshold_0.5" in got and "dice_loss" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_multilabel_matches_jax():
    """Per-class counts in buffers sized by number_of_classes, trimmed to
    the prediction's channels, macro-averaged."""
    rng = np.random.default_rng(2)
    batches = [(rng.random((2, 6, 6, 3)).astype(np.float32),
                (rng.random((2, 6, 6, 3)) < 0.4).astype(np.float32))
               for _ in range(2)]
    got, want = _run_both({"multilabel": True, "number_of_classes": 5},
                          batches, names=("metrics.DiceIndex",
                                          "metrics.Precision"))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)


def test_bf16_prediction_is_counted_in_float32():
    port = MetricsCalculator(ConfigDict(_config({})))
    pred = torch.tensor([[0.5], [0.49]]).bfloat16()
    state, per_batch = port.update(port.init_state("cpu"), pred,
                                   {"mask": torch.tensor([1, 0])})
    assert per_batch["true_positives_threshold_0.5"].item() == 1.0
    assert state["cm_0.5"]["tn"].dtype == torch.float32


@pytest.mark.parametrize("name", [
    "metrics.AUROC", "metrics.AveragePrecision",
    "metrics.ModifiedHausdorffDistance",
    "metrics.multiclass_metrics.DiceIndex", "metrics.ROCCurve"])
def test_unported_metrics_raise(name):
    """The names the port refused before the metric suite came over now
    build the same specs as JAX's calculator (a host logger's name builds
    none: the trainer builds the logger)."""
    cfg = _config({"number_of_classes": 3}, names=("metrics.DiceIndex",
                                                     name))
    port = MetricsCalculator(ConfigDict(cfg))
    assert port.specs.keys() == JaxCalculator(JaxConfigDict(cfg)).specs.keys()
    assert (len(port.specs) > 2) == (name != "metrics.ROCCurve")


def test_log_confusion_matrix_raises():
    """``log_confusion_matrix`` builds the K x K accumulator and asks for
    the last pass, as in JAX."""
    cfg = _config({"log_confusion_matrix": True, "number_of_classes": 3},
                  names=("metrics.DiceIndex",))
    port = MetricsCalculator(ConfigDict(cfg))
    assert "multiclass_cm" in port.specs and port.requires_last_pass
    assert port.specs.keys() == JaxCalculator(JaxConfigDict(cfg)).specs.keys()


def test_multilabel_target_broadcasts_like_jax():
    """A (B, H, W, 1) target against a three-class prediction broadcasts
    over the classes, as in JAX (the port used to raise)."""
    rng = np.random.default_rng(4)
    batches = [(rng.random((2, 6, 6, 3)).astype(np.float32),
                (rng.random((2, 6, 6, 1)) < 0.4).astype(np.float32))
               for _ in range(2)]
    got, want = _run_both({"multilabel": True, "number_of_classes": 3},
                          batches, names=("metrics.DiceIndex",
                                          "metrics.Accuracy"))
    assert got.keys() == want.keys() and want
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)
