"""Host-side epoch loggers: sample-image panels and ROC / PR curves.

The port of ``metrics/host_loggers.py`` (the reference's ``ImageLogger``,
``segmentation/image_logging/img_vis.py:16-298``, and ``Curve`` /
``ROCCurve`` / ``PrecisionRecallCurve``, ``metrics/metrics.py:452-651``).
They are epoch-end hooks: at active epochs the trainer hands them the data
loader and a forward on the device, and they pull only the batches they
plot, so the hot loop stays free of host syncs.

The curves are computed in numpy with scikit-learn's rules
(``roc_curve`` with its dropped collinear points, ``precision_recall_curve``)
and exported through ``plotting``; json needs nothing installed.  Under
data parallelism every process walks the loaders as the main process does
(their data streams stay in step) and only the main process writes.
``ImageLogger`` draws with matplotlib, imported when it draws: without it
the logger raises inside the trainer's error envelope and the run goes on.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Sequence

import numpy as np

from ..config import ConfigDict
from ..parallel import is_main_process
from ..utils import handle_exception

__all__ = ["HostLogger", "ImageLogger", "CurveLogger", "ROCCurve",
           "PrecisionRecallCurve", "build_host_loggers", "HOST_LOGGER_NAMES",
           "roc_curve", "precision_recall_curve"]

HOST_LOGGER_NAMES = {
    "segmentation.image_logging.ImageLogger": "image_logger",
    "metrics.ROCCurve": "roc_curve",
    "metrics.PrecisionRecallCurve": "precision_recall_curve",
}


def _epoch_list(spec) -> list:
    if isinstance(spec, (str, int)):
        spec = [spec]
    return list(spec)


def _binary_clf_curve(y_true, y_score):
    """(fps, tps) at each distinct score, descending (scikit-learn's
    ``confusion_matrix_at_thresholds`` for 0/1 labels, no weights)."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = y_true[order].astype(np.float64)
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps


def roc_curve(y_true, y_score):
    """(fpr, tpr) of ``sklearn.metrics.roc_curve`` (collinear points
    dropped, the curve starting at (0, 0))."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps = fps[keep], tps[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr


def precision_recall_curve(y_true, y_score):
    """(precision, recall) of ``sklearn.metrics.precision_recall_curve``:
    recall decreasing, ending at (1, 0)."""
    fps, tps = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0]


class HostLogger:
    """Epoch-end logger protocol: ``active(epoch)`` + ``log(...)``."""

    def __init__(self, active_epochs, num_epochs: int):
        epochs = _epoch_list(active_epochs)
        self.do_last = "last" in epochs
        # 'last' fires once after training (the trainer's extra last pass),
        # not at the final regular epoch as well
        self.active_epochs = [int(e) for e in epochs if e != "last"]
        self.num_epochs = num_epochs

    def active(self, epoch: int, last: bool = False) -> bool:
        return (last and self.do_last) or epoch in self.active_epochs

    def log(self, epoch: int, loader, forward: Callable, train: bool,
            last: bool = False) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class ImageLogger(HostLogger):
    """Sample-prediction panels at active epochs.

    Binary: original / ground truth / raw prediction / one panel per
    threshold (optionally with the ground-truth contour); multiclass: the
    colour-mapped ground truth and argmax prediction with a class legend.
    Files land in ``Sample images/epoch_{i}/{train|val}/img_{k}.png``.
    """

    PARAMS = {
        "number of images to save": {"argument name": "num_imgs",
                                     "default": 5},
        "save sample images at": {"argument name": "active_epochs",
                                  "default": "last"},
        "draw mask contour": False,
        "image scan stall window": 0,
    }

    def __init__(self, config_dict: ConfigDict, destination: str,
                 class_names: Sequence[str] = (), extension: str = "png"):
        params = config_dict["metrics/calculation"]
        num_epochs = config_dict["experiment/number of epochs"]
        super().__init__(params.get("save sample images at", "last"),
                         num_epochs)
        self.number_of_imgs = params.get("number of images to save", 5)
        self.num_classes = params.get("number_of_classes", 1) or 1
        self.thresholds = params.get_tuple("thresholds", 0.5)
        self.draw_contour = params.get("draw mask contour", False)
        # 0 scans the whole loader like the reference; a positive value
        # bounds the fruitless batches per scan (never on the 'last' pass)
        self.stall_window = int(params.get("image scan stall window", 0)
                                or 0)
        self.extension = extension.lower()
        self.class_names = [str(c).replace("_", " ") for c in class_names]
        if self.num_classes > 1 and len(self.class_names) \
                == self.num_classes:
            self.class_names = self.class_names[1:]
        self.save_path = os.path.join(destination, "Sample images")

    def _binary_figure(self, plt, img, mask, pred):
        panels = {"original image": img, "ground truth": mask,
                  "raw prediction": pred}
        panels.update({f"threshold {t}": (pred > t).astype(float)
                       for t in self.thresholds})
        n_panels = len(panels)
        n = int(math.floor(math.sqrt(n_panels)))
        k = int(math.ceil(n_panels / n))
        fig = plt.figure(figsize=(6 * k, 6 * n))
        for i, (label, array) in enumerate(panels.items()):
            ax = fig.add_subplot(n, k, i + 1)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_xlabel(label, size=16)
            ax.imshow(array, cmap="Greys", vmin=0, vmax=1)
            if self.draw_contour:
                # every panel, the ground truth's too (img_vis.py:178-180)
                ax.contour(mask, colors="red")
        return fig

    def _class_colors(self):
        from matplotlib import cm
        n = self.num_classes - 1
        if n <= 10:
            palette = [cm.tab10(i) for i in range(n)]
        elif n <= 20:
            palette = [cm.tab20(i) for i in range(n)]
        else:
            palette = [cm.turbo(i / max(1, n - 1)) for i in range(n)]
        return [(1.0, 1.0, 1.0, 1.0)] + palette  # background white

    def _multiclass_figure(self, plt, img, mask, pred):
        from matplotlib.colors import ListedColormap
        colors = self._class_colors()
        cmap = ListedColormap(colors)
        pred_labels = pred.argmax(-1) if pred.ndim == 3 else pred
        panels = {"original image": (img, "Greys", None),
                  "ground truth": (mask, cmap, self.num_classes - 1),
                  "prediction": (pred_labels, cmap, self.num_classes - 1)}
        fig = plt.figure(figsize=(24, 6))
        for i, (label, (array, colmap, vmax)) in enumerate(panels.items()):
            ax = fig.add_subplot(1, 4, i + 1)
            ax.set_xticks([])
            ax.set_yticks([])
            ax.set_xlabel(label, size=16)
            ax.imshow(array, cmap=colmap, vmin=0, vmax=vmax)
        legend_ax = fig.add_subplot(1, 4, 4)
        legend_ax.set_frame_on(False)
        legend_ax.set_xticks([])
        legend_ax.set_yticks([])
        handles = [legend_ax.scatter([], [], marker="s", color=c)
                   for c in colors[1:]]
        labels = self.class_names or [f"class {i + 1}" for i in
                                      range(self.num_classes - 1)]
        legend_ax.legend(handles, labels, loc="center", fontsize=18,
                         frameon=False, markerscale=4.5)
        return fig

    def log(self, epoch: int, loader, forward: Callable, train: bool,
            last: bool = False) -> None:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        out_dir = os.path.join(self.save_path, f"epoch_{epoch}",
                               "train" if train else "val")
        # under data parallelism every process walks the loaders alike (so
        # their data streams stay in step); the main process draws
        write = is_main_process()
        if write:
            os.makedirs(out_dir, exist_ok=True)
        saved, last_progress = 0, 0
        stall_window = self.stall_window if not last else 0
        for batch_idx, batch in enumerate(loader):
            if saved >= self.number_of_imgs \
                    or (stall_window
                        and batch_idx - last_progress >= stall_window):
                break
            mask_src = batch.get("mask", batch.get("label"))
            if mask_src is None:
                handle_exception(
                    KeyError("batch has neither 'mask' nor 'label'"),
                    "ImageLogger cannot find targets; skipping.")
                return
            mask = np.asarray(mask_src)
            if not np.any(mask > 0):
                # an all-negative batch saves no image: no forward for it
                continue
            x = np.asarray(batch["x"])
            pred = np.asarray(forward(batch["x"]))
            for i in range(len(x)):
                if saved >= self.number_of_imgs:
                    break
                y = mask[i]
                if not np.any(y > 0):
                    continue
                img = np.squeeze(x[i]).astype(np.float32)
                # integer-valued images (uint8, or 0-255 floats) go to
                # [0, 1] before the grayscale inversion
                if img.size and np.all(np.mod(img, 1) == 0) \
                        and img.max() > 1:
                    img = img / 255.0
                if img.ndim == 2:
                    img = 1 - img
                y_hat = np.squeeze(pred[i])
                if not write:
                    saved += 1
                    last_progress = batch_idx
                    continue
                try:
                    if self.num_classes == 1:
                        fig = self._binary_figure(plt, img, np.squeeze(y),
                                                  y_hat)
                    else:
                        fig = self._multiclass_figure(plt, img,
                                                      np.squeeze(y), y_hat)
                    saved += 1
                    last_progress = batch_idx
                    try:
                        fig.savefig(os.path.join(
                            out_dir, f"img_{saved}.{self.extension}"),
                            bbox_inches="tight")
                    finally:
                        plt.close(fig)
                except Exception as exc:  # noqa: BLE001
                    handle_exception(exc, "Exception while logging a "
                                          "sample image.")


class CurveLogger(HostLogger):
    """Base of the ROC and PR curves, sampled from N batches at active
    epochs."""

    PARAMS = {
        "calculate curves at": {"argument name": "active_epochs",
                                "default": "last"},
        "number of batches to sample curves from": {
            "argument name": "num_batches", "default": 5},
    }

    dir_name = "curves"

    def __init__(self, config_dict: ConfigDict, destination: str,
                 train_colour: str = "blue", val_colour: str = "orange"):
        params = config_dict["metrics/calculation"]
        num_epochs = config_dict["experiment/number of epochs"]
        super().__init__(params.get("calculate curves at", "last"),
                         num_epochs)
        self.number_of_batches = params.get(
            "number of batches to sample curves from", 5)
        self.train_colour = train_colour
        self.val_colour = val_colour
        self.extensions = config_dict.get_str_tuple(
            "meta/technical/export_plots_as")
        self.save_path = os.path.join(destination, self.dir_name)

    def _collect(self, loader, forward, label_key=("mask", "label")):
        ys, scores, used = [], [], 0
        for batch in loader:
            if used >= self.number_of_batches:
                break
            y = None
            for key in label_key:
                if key in batch:
                    y = np.asarray(batch[key]).reshape(-1)
                    break
            if y is None or not np.any(y == 1):
                continue  # the reference skips all-negative batches
            ys.append(y)
            scores.append(np.asarray(forward(batch["x"])).reshape(-1))
            used += 1
        if not ys:
            return None, None
        return np.concatenate(ys), np.concatenate(scores)

    def log(self, epoch: int, loader, forward: Callable, train: bool,
            last: bool = False) -> None:
        y, y_hat = self._collect(loader, forward)
        if y is None or not is_main_process():
            return
        os.makedirs(self.save_path, exist_ok=True)
        self._export(epoch, y, y_hat, train)

    def _export(self, epoch, y, y_hat, train):  # pragma: no cover
        raise NotImplementedError

    def _plot(self, train: bool, fname: str, **params) -> None:
        from ..plotting import GeneralPlotter, export_plot
        params.update(fname=("" if train else "val_") + fname,
                      dirname=self.save_path)
        export_plot(GeneralPlotter(params), self.extensions)


class ROCCurve(CurveLogger):
    dir_name = "ROC_curves"
    name = "roc_curve"

    def _export(self, epoch, y, y_hat, train):
        fpr, tpr = roc_curve(y, y_hat)
        kind = "train" if train else "validation"
        self._plot(train, f"roc_curve_epoch_{epoch}",
                   Ys=[list(tpr), [0, 1]], x=list(fpr),
                   xlabel="false positive rate",
                   ylabel="true positive rate",
                   title=f"{kind} ROC curve at epoch {epoch}",
                   colors=[self.train_colour if train else self.val_colour,
                           "lightgrey"], dashes=["solid", "dashed"])


class PrecisionRecallCurve(CurveLogger):
    dir_name = "Precision-recall_curves"
    name = "precision_recall_curve"

    def _export(self, epoch, y, y_hat, train):
        precision, recall = precision_recall_curve(y, y_hat)
        kind = "train" if train else "validation"
        self._plot(train, f"precision_recall_curve_epoch_{epoch}",
                   Ys=[list(precision)], x=list(recall),
                   xlabel="recall", ylabel="precision",
                   title=f"{kind} precision-recall curve at epoch {epoch}",
                   colors=[self.train_colour if train
                           else self.val_colour])


#: the constructors of HOST_LOGGER_NAMES' loggers
_LOGGER_CLASSES = {
    "segmentation.image_logging.ImageLogger":
        lambda cfg, dest, class_names: ImageLogger(
            cfg, dest, class_names=class_names),
    "metrics.ROCCurve": lambda cfg, dest, class_names: ROCCurve(cfg, dest),
    "metrics.PrecisionRecallCurve":
        lambda cfg, dest, class_names: PrecisionRecallCurve(cfg, dest),
}


def build_host_loggers(config_dict: ConfigDict, destination: str,
                       class_names: Sequence[str] = ()) -> list:
    """Instantiate the host loggers named in ``metrics/metrics``."""
    requested = config_dict.get_str_tuple("metrics/metrics") \
        if config_dict.has("metrics/metrics") else ()
    return [_LOGGER_CLASSES[name](config_dict, destination, class_names)
            for name in requested if name in _LOGGER_CLASSES]
