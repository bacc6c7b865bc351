"""The port's metric suite against the JAX package's, on the CPU, within
1e-6: the EDT (2-D and 3-D, with and without spacing), the object borders,
HD95 per sample and as a spec, AUROC and AP with ties, the score histogram
and the AUC spec's per-batch, epoch and pooled values, every multiclass
spec through both MetricsCalculators under the JAX table's names (classwise
columns, background in the averages or not, an absent class, the K x K
matrix, the last-pass flag and the classwise history plot), and the medpy
surface-distance API.

Inputs are drawn from a seed with numpy and fed to both packages.  The
histogram's scores sit at bin centres: torch's and XLA's sigmoid may round
a score to the other side of a bin edge, which moves a pooled value by
about 1/(P*N); the per-batch values take any score."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.metrics import \
    MetricsCalculator as JaxCalculator
from medsegpretrainimagenet_tpu.metrics import auc as jax_auc
from medsegpretrainimagenet_tpu.metrics import hd95 as jax_hd95
from medsegpretrainimagenet_tpu.metrics import surface as jax_surface
from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
from medsegpretrainimagenet_tpu_torch.metrics import auc, hd95, surface

TOL = 1e-6
MC = "metrics.multiclass_metrics."
MC_NAMES = tuple(MC + n for n in (
    "Accuracy", "DiceIndex", "JaccardIndex", "BalancedAccuracy",
    "ClasswiseAccuracies", "ClasswiseBalancedAccuracies",
    "ClasswiseDiceIndices", "AUROC", "AveragePrecision",
    "ModifiedHausdorffDistance"))


class _Named:
    name = "dice_loss"


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=TOL,
                               atol=TOL, err_msg=what)


def _blobs(rng, n, size, count=3):
    """(n, size, size) masks of a few discs each (empty where count=0)."""
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((n, size, size), bool)
    for m in out:
        for _ in range(count):
            cy, cx = rng.integers(0, size, 2)
            r = rng.integers(2, size // 3)
            m[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = True
    return out


@pytest.mark.parametrize("shape, spacing", [
    ((24, 20), None), ((24, 20), (1.5, 0.7)), ((7, 9, 11), None),
    ((7, 9, 11), (2.0, 1.0, 0.5))], ids=["2d", "2d_spacing", "3d",
                                         "3d_spacing"])
def test_edt_matches_jax(shape, spacing):
    mask = np.random.default_rng(0).random(shape) < 0.08
    got = hd95.edt(torch.from_numpy(mask), spacing).numpy()
    want = np.asarray(jax_hd95.edt(jnp.asarray(mask), spacing))
    _close(got, want)
    # a batch of masks gives each mask's own transform
    batch = np.stack([mask, ~mask, np.zeros_like(mask)])
    got = hd95.edt_batch(torch.from_numpy(batch), len(shape), spacing)
    for k in range(3):
        _close(got[k].numpy(), np.asarray(jax_hd95.edt(
            jnp.asarray(batch[k]), spacing)))


@pytest.mark.parametrize("connectivity", [1, 2, 3])
def test_object_border_matches_jax(connectivity):
    mask = np.random.default_rng(1).random((6, 8, 9)) < 0.5
    got = hd95.object_border(torch.from_numpy(mask), connectivity).numpy()
    want = np.asarray(jax_hd95.object_border(jnp.asarray(mask),
                                             connectivity))
    np.testing.assert_array_equal(got, want)


def test_hd95_single_matches_jax():
    rng = np.random.default_rng(2)
    pred, true = _blobs(rng, 6, 32), _blobs(rng, 6, 32)
    pred[4] = False            # an empty prediction: skipped
    values, valids = hd95.hd95_batch(torch.from_numpy(pred),
                                     torch.from_numpy(true))
    for k in range(6):
        value, valid = jax_hd95.hd95_single(jnp.asarray(pred[k]),
                                            jnp.asarray(true[k]))
        _close(values[k], value, f"sample {k}")
        assert bool(valids[k]) == bool(valid)
        single = hd95.hd95_single(torch.from_numpy(pred[k]),
                                  torch.from_numpy(true[k]))
        _close(single[0], value)
    assert not bool(valids[4]) and float(values[4]) == 0.0


def _bin_centred_scores(rng, shape, ties: bool = False):
    """Probabilities whose sigmoid sits at the centre of a histogram bin."""
    k = rng.integers(32768, 47000, shape)
    if ties:
        k[..., ::3] = k.reshape(-1)[0]
    c = (k + 0.5) / auc.N_BINS
    return np.log(c / (1 - c)).astype(np.float32)


@pytest.mark.parametrize("kind", ["auroc", "average_precision"])
def test_auc_values_match_jax(kind):
    rng = np.random.default_rng(3)
    scores = rng.random(2000).astype(np.float32)
    scores[:700] = np.round(scores[:700], 2)     # tie groups
    labels = (rng.random(2000) < 0.3).astype(np.float32)
    for y in (labels, np.zeros_like(labels), np.ones_like(labels)):
        got = getattr(auc, kind)(torch.from_numpy(scores),
                                 torch.from_numpy(y))
        want = getattr(jax_auc, kind)(jnp.asarray(scores), jnp.asarray(y))
        _close(got[0], want[0], kind)
        assert bool(got[1]) == bool(want[1])


def test_score_histogram_matches_jax():
    rng = np.random.default_rng(4)
    scores = _bin_centred_scores(rng, (3000,), ties=True)
    labels = (rng.random(3000) < 0.4).astype(np.float32)
    got = auc.score_histogram(torch.from_numpy(scores),
                              torch.from_numpy(labels), squash=True)
    want = jax_auc.score_histogram(jnp.asarray(scores), jnp.asarray(labels),
                                   squash=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("auroc_from_counts", "average_precision_from_counts"):
        _close(getattr(auc, name)(*(t.numpy() for t in got))[0],
               getattr(jax_auc, name)(*(np.asarray(t) for t in want))[0])


def _run_both(names, calculation, batches, class_names=None):
    """Both calculators over *batches* of (prediction, mask); asserts the
    per-step values and the epoch rows agree and returns (port, ref, port
    row, port state, ref state)."""
    cfg = {"metrics": {"metrics": tuple(names),
                       "calculation": dict(calculation)}}
    port = MetricsCalculator(ConfigDict(cfg), loss=_Named(),
                             class_names=class_names)
    ref = JaxCalculator(JaxConfigDict(cfg), loss=_Named(),
                        class_names=class_names)
    assert port.specs.keys() == ref.specs.keys()
    assert port.requires_last_pass == ref.requires_last_pass
    state, ref_state = port.init_state("cpu"), ref.init_state()
    for step, (pred, mask) in enumerate(batches):
        loss = 0.1 * (step + 1)
        state, per_batch = port.update(
            state, torch.from_numpy(pred), {"mask": torch.from_numpy(mask)},
            loss_value=torch.tensor(loss))
        ref_state, ref_batch = ref.update(
            ref_state, jnp.asarray(pred), {"mask": jnp.asarray(mask)},
            loss_value=jnp.asarray(loss, jnp.float32))
        assert per_batch.keys() == ref_batch.keys()
        for key in per_batch:
            _close(per_batch[key], ref_batch[key], key)
        got, want = port.batch_values(per_batch), ref.batch_values(ref_batch)
        assert got.keys() == want.keys()
        for key in want:
            _close(got[key], want[key], key)
    got, want = port.finalize_epoch(state), ref.finalize_epoch(ref_state)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key], key)
    return port, ref, got, state, ref_state


@pytest.mark.parametrize("names", [
    ("metrics.ModifiedHausdorffDistance", "metrics.DiceIndex"),
    ("metrics.AUROC",), ("metrics.AveragePrecision",),
    ("metrics.DiceIndex", "metrics.JaccardIndex", "metrics.MCC",
     "metrics.ModifiedHausdorffDistance", "metrics.AUROC")],
    ids=["hd95", "auroc", "average_precision", "covidqu_set"])
def test_binary_specs_match_jax(names):
    """Per-step values, the epoch row and (for AUC) the pooled column; the
    HD95 batches include an empty mask, the AUC ones a batch of one
    class."""
    rng = np.random.default_rng(5)
    batches = []
    for step in range(3):
        mask = _blobs(rng, 4, 24).astype(np.float32)
        pred = _bin_centred_scores(rng, (4, 24, 24, 1))
        pred = np.where(_blobs(rng, 4, 24)[..., None], pred + 0.3, pred)
        if step == 1:
            mask[2] = 0          # HD95 skips this sample
        if step == 2:
            mask[:] = 0          # AUC: an invalid batch
        batches.append((pred.astype(np.float32), mask))
    _, _, row, _, _ = _run_both(names, {"thresholds": (0.5, 0.7)}, batches)
    if "metrics.AUROC" in names:
        assert "metrics/area_under_roc_pooled" in row
    if "metrics.ModifiedHausdorffDistance" in names:
        assert row["metrics/modified_hausdorff_distance_threshold_0.7"] > 0


def _multiclass_batches(seed, k=4, n_steps=3, absent=None, logits=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        mask = rng.integers(0, k, (3, 20, 20)).astype(np.int32)
        # shapes, so that HD95 sees objects and not noise
        blobs = _blobs(rng, 3, 20, count=2)
        mask = np.where(blobs, mask % 2 + 1, 0).astype(np.int32)
        mask[0, :4, :4] = k - 1
        raw = rng.normal(size=(3, 20, 20, k)).astype(np.float32)
        raw += 2.5 * np.eye(k, dtype=np.float32)[mask]
        if absent is not None:
            mask[mask == absent] = 0
            raw[..., absent] = -20.0
        pred = raw if logits else np.exp(raw) / np.exp(raw).sum(
            -1, keepdims=True)
        out.append((pred.astype(np.float32), mask))
    return out


@pytest.mark.parametrize("include_background", [False, True])
@pytest.mark.parametrize("absent", [None, 3], ids=["all", "absent_class"])
def test_multiclass_specs_match_jax(include_background, absent):
    calculation = {"number_of_classes": 4,
                   "include_background_in_averages": include_background,
                   "log_classwise_jaccard_idcs": True,
                   "log_confusion_matrix": True}
    names = ("RV cavity", "myocardium", "LV cavity")
    port, ref, row, state, ref_state = _run_both(
        MC_NAMES, calculation, _multiclass_batches(6, absent=absent),
        class_names=names)
    np.testing.assert_array_equal(port.epoch_confusion_matrix(state),
                                  ref.epoch_confusion_matrix(ref_state))
    assert port.requires_last_pass
    assert "metrics/dice_index_RV_cavity" in row
    assert "metrics/jaccard_index_LV_cavity" in row
    # three names for four averaged classes: the last goes by its index
    assert ("metrics/dice_index_class_3" in row) == include_background
    assert row["metrics/modified_hausdorff_distance"] > 0


def test_multiclass_softmax_auc_and_top5_match_jax():
    """AUROC / AP with ``apply_softmax`` over logits, and the pooled top-5
    accuracy over seven classes (continuous logits: no tie at the 5th
    place, where ``topk`` and ``lax.top_k`` may keep different members)."""
    _run_both((MC + "AUROC", MC + "AveragePrecision", MC + "Top5Accuracy",
               MC + "Accuracy"),
              {"number_of_classes": 7, "apply_softmax": True},
              _multiclass_batches(7, k=7, logits=True))


def test_classwise_history_plot_matches_jax(tmp_path):
    """``evaluate_at_end`` reads the classwise val columns back out of
    epoch_logs.csv and exports the same plot json."""
    rows = "epoch,val_metrics/dice_index_RV_cavity,val_metrics/" \
           "dice_index_myocardium,val_metrics/dice_index_LV_cavity\n" \
           "1,0.5,0.6,0.7\n2,0.55,0.65,0.8\n"
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "epoch_logs.csv").write_text(rows)
    cfg = {"metrics": {"metrics": (MC + "DiceIndex",),
                       "calculation": {"number_of_classes": 4}}}
    names = ("RV cavity", "myocardium", "LV cavity")
    for cd, calc_cls, pkg in ((ConfigDict, MetricsCalculator, "port"),
                              (JaxConfigDict, JaxCalculator, "jax")):
        calc_cls(cd(cfg), class_names=names).evaluate_at_end(
            save_path=str(tmp_path / pkg), extensions=("json",))
    got, want = (json.loads((tmp_path / pkg / "plots"
                             / "dice_indices_plot.json").read_text())
                 for pkg in ("port", "jax"))
    got.pop("dirname"), want.pop("dirname")
    assert got == want and got["Ys"][2] == [0.7, 0.8]


def _surface_inputs():
    rng = np.random.default_rng(8)
    result = _blobs(rng, 1, 40, count=4)[0]
    reference = _blobs(rng, 1, 40, count=4)[0]
    vol_r = rng.random((9, 10, 11)) < 0.3
    vol_g = rng.random((9, 10, 11)) < 0.3
    return result, reference, vol_r, vol_g


@pytest.mark.parametrize("name", [
    "dc", "jc", "precision", "recall", "sensitivity", "specificity",
    "true_negative_rate", "true_positive_rate", "positive_predictive_value",
    "ravd", "hd", "hd95", "asd", "assd", "obj_asd", "obj_assd", "obj_fpr",
    "obj_tpr"])
def test_surface_functions_match_jax(name):
    result, reference, vol_r, vol_g = _surface_inputs()
    cases = [(result, reference, {}), (vol_r, vol_g, {})]
    if name in ("hd", "hd95", "asd", "assd", "obj_asd", "obj_assd"):
        cases += [(result, reference, {"voxelspacing": (1.5, 0.5)}),
                  (vol_r, vol_g, {"voxelspacing": (2.0, 1.0, 0.7),
                                  "connectivity": 2})]
    for a, b, kwargs in cases:
        _close(getattr(surface, name)(a, b, **kwargs),
               getattr(jax_surface, name)(a, b, **kwargs), name)


def test_surface_arrays_and_correlations_match_jax():
    result, reference, vol_r, vol_g = _surface_inputs()
    for conn in (1, 2):
        _close(surface.surface_distances(result, reference,
                                         connectivity=conn),
               jax_surface.surface_distances(result, reference,
                                             connectivity=conn))
        labels, n = surface.connected_components(vol_r, conn)
        want, n_want = jax_surface.connected_components(vol_r, conn)
        assert n == n_want
        np.testing.assert_array_equal(labels, want)
    rng = np.random.default_rng(9)
    results = rng.random((6, 10, 10)) < rng.random((6, 1, 1))
    references = results ^ (rng.random((6, 10, 10)) < 0.05)
    for name in ("volume_correlation", "volume_change_correlation"):
        got = getattr(surface, name)(results, references)
        want = getattr(jax_surface, name)(results, references)
        _close(got, want, name)
    with pytest.raises(RuntimeError):
        surface.hd(np.zeros((4, 4)), reference[:4, :4])
