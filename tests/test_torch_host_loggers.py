"""The port's host-side epoch loggers and the confusion-matrix plotter
against the JAX package's, on the CPU: the same batches and the same
forward give the same ROC and precision-recall curve jsons (within 1e-6)
and the same sample-image files; ``ConfMtxPlotter`` writes the same json;
the curves follow scikit-learn's.  Without matplotlib the image logger
fails inside the trainer's error envelope and the run goes on."""
import json
import sys

import numpy as np
import pytest
import sklearn.metrics

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.metrics import \
    build_host_loggers as jax_build
from medsegpretrainimagenet_tpu.plotting import \
    ConfMtxPlotter as JaxConfMtxPlotter
from medsegpretrainimagenet_tpu.plotting import export_plot as jax_export
from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.metrics import build_host_loggers
from medsegpretrainimagenet_tpu_torch.metrics import host_loggers
from medsegpretrainimagenet_tpu_torch.plotting import (ConfMtxPlotter,
                                                       export_plot)

TOL = 1e-6
LOGGERS = ("segmentation.image_logging.ImageLogger", "metrics.ROCCurve",
           "metrics.PrecisionRecallCurve")


def _config(calculation=None, epochs=3):
    calc = {"thresholds": (0.3, 0.5), "label_type": "mask",
            "number_of_images_to_save": 2,
            "save_sample_images_at": (1, "last"),
            "calculate_curves_at": (2, "last"),
            "number_of_batches_to_sample_curves_from": 2}
    calc.update(calculation or {})
    return {"metrics": {"metrics": ("metrics.DiceIndex",) + LOGGERS,
                        "calculation": calc},
            "experiment": {"number_of_epochs": epochs},
            "meta": {"technical": {"export_plots_as": ("json",)}}}


def _batches(n_batches=4, bs=3, size=12, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_batches):
        x = rng.random((bs, size, size, 1)).astype(np.float32)
        mask = (x[..., 0] > 0.6).astype(np.int32)
        if k == 0:
            mask[:] = 0       # skipped by every logger
        out.append({"x": x, "mask": mask})
    return out


def _forward(x):
    return np.round(np.asarray(x)[..., 0] * 0.8 + 0.1, 2)  # tie groups


def _jsons(directory):
    out = {}
    for path in sorted(directory.rglob("*.json")):
        payload = json.loads(path.read_text())
        payload.pop("dirname", None)
        out[str(path.relative_to(directory))] = payload
    return out


def _assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for key in want:
            _assert_same(got[key], want[key], f"{what}/{key}")
    elif isinstance(want, list) and want and not isinstance(want[0], str):
        assert len(got) == len(want), what
        for a, b in zip(got, want):
            _assert_same(a, b, what)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)
    else:
        assert got == want, what


def test_loggers_build_and_activate_like_jax(tmp_path):
    port = build_host_loggers(ConfigDict(_config()), str(tmp_path))
    ref = jax_build(JaxConfigDict(_config()), str(tmp_path))
    assert [type(lg).__name__ for lg in port] \
        == [type(lg).__name__ for lg in ref] \
        == ["ImageLogger", "ROCCurve", "PrecisionRecallCurve"]
    for a, b in zip(port, ref):
        for epoch in (1, 2, 3):
            for last in (False, True):
                assert a.active(epoch, last) == b.active(epoch, last)


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_curves_and_images_match_jax(tmp_path, train):
    """Every logger of both packages over the same batches: the same files,
    the curve jsons within 1e-6."""
    for pkg, cd, build in (("port", ConfigDict, build_host_loggers),
                           ("jax", JaxConfigDict, jax_build)):
        for logger in build(cd(_config()), str(tmp_path / pkg)):
            logger.log(2, _batches(), _forward, train=train, last=True)

    def files(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                      if p.is_file())
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert len([f for f in files(tmp_path / "port")
                if f.endswith(".png")]) == 2
    got, want = _jsons(tmp_path / "port"), _jsons(tmp_path / "jax")
    assert len(want) == 2
    _assert_same(got, want)


def test_curves_match_sklearn():
    rng = np.random.default_rng(1)
    y = (rng.random(500) < 0.3).astype(np.int32)
    scores = np.round(rng.random(500), 2)
    fpr, tpr = host_loggers.roc_curve(y, scores)
    want = sklearn.metrics.roc_curve(y, scores)
    np.testing.assert_allclose(fpr, want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tpr, want[1], rtol=TOL, atol=TOL)
    precision, recall = host_loggers.precision_recall_curve(y, scores)
    want = sklearn.metrics.precision_recall_curve(y, scores)
    np.testing.assert_allclose(precision, want[0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(recall, want[1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("normalise", [True, False])
def test_confusion_matrix_json_matches_jax(tmp_path, normalise):
    cm = np.array([[50., 2., 0., 1.], [3., 40., 5., 0.], [0., 0., 0., 0.],
                   [1., 0., 2., 30.]], np.float32)
    params = {"matrix": cm, "labels": ["bg", "RV", "myo", "LV"],
              "title": "Validation confusion matrix at epoch 2",
              "fname": "val_confusion_matrix_epoch_2",
              "normalise": normalise}
    export_plot(ConfMtxPlotter(dict(params, dirname=str(tmp_path / "p"))),
                ["json"])
    jax_export(JaxConfMtxPlotter(dict(params,
                                      dirname=str(tmp_path / "j"))),
               ["json"])
    got, want = _jsons(tmp_path / "p"), _jsons(tmp_path / "j")
    assert got == want and got[
        "val_confusion_matrix_epoch_2.json"]["matrix"][1] == [3, 40, 5, 0]
    plotter = ConfMtxPlotter(dict(params))
    np.testing.assert_allclose(plotter._normalised(),
                               JaxConfMtxPlotter(dict(params))._normalised())


def test_image_logger_without_matplotlib_stays_in_the_envelope(
        tmp_path, monkeypatch, capsys):
    """A one-epoch run with the image logger and no matplotlib: the logger
    raises inside the envelope, the epoch row and the curves are written."""
    from medsegpretrainimagenet_tpu_torch.config import registry
    from medsegpretrainimagenet_tpu_torch.losses import DiceLoss, Loss
    from medsegpretrainimagenet_tpu_torch.metrics import MetricsCalculator
    from medsegpretrainimagenet_tpu_torch.models import Model
    from medsegpretrainimagenet_tpu_torch.optim import Optimizer
    from medsegpretrainimagenet_tpu_torch.train import (TrainState,
                                                        train_model)

    from torch_port_helpers import build_model, unet_config

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    model = build_model(ConfigDict, registry, Model,
                        unet_config(channels=(4, 8), in_channels=1))
    model.init(0)
    optimizer = Optimizer(ConfigDict({"sgd": {}}), num_epochs=1,
                          batches_per_epoch=4)
    state = TrainState.create(model.module, optimizer.init(model.module), 0)
    loss = Loss(DiceLoss, ConfigDict({"label type": "mask"}))
    cfg = ConfigDict(_config(epochs=1))
    cfg["meta/technical/absolute path"] = str(tmp_path) + "/"
    cfg["meta/technical/log_best_model"] = False
    loggers = build_host_loggers(cfg, str(tmp_path / "run") + "/")
    batches = _batches()
    train_model(model, batches, batches, None, cfg, optimizer, state,
                loss=loss, metrics_and_loss=MetricsCalculator(cfg,
                                                               loss=loss),
                name="run", virtual_batch_size=3, true_batch_size=3,
                verbose=False, device="cpu", host_loggers=loggers)
    assert "Exception in a host epoch logger." in capsys.readouterr().err
    assert (tmp_path / "run" / "epoch_logs.csv").is_file()
    assert list((tmp_path / "run" / "ROC_curves").glob("*.json"))
