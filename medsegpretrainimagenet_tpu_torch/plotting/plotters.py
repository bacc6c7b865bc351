"""Plot/export framework (host-side).

The port's own copy of the part of ``medsegpretrainimagenet_tpu/plotting/
plotters.py`` that the CLI uses: ``BasePlotter``, ``GeneralPlotter``
(multi-line metric curves with legends, baselines, log scale) and
``ConfMtxPlotter`` (the confusion-matrix export), ``ScatterPlotter``
and ``PCAPlotter`` (a 2-D PCA scatter, with the TensorFlow projector's tsv
export), exporting to json / png / svg / html.  JSON export writes the full parameter tree (so
plots can be re-rendered later) and needs nothing installed; png/svg use
matplotlib and html uses bokeh, each imported only when its format is
asked for (html falls back to png with a warning without bokeh).

``export_plot`` fans one plotter out to the configured formats under a
watchdog timeout, mirroring ``utils/_utils.py:169-182``.
"""
from __future__ import annotations

import json
import os
import signal
import warnings
from typing import Any, Dict, Iterable

import numpy as np

from ..utils import handle_exception

__all__ = ["BasePlotter", "GeneralPlotter", "ConfMtxPlotter",
           "ScatterPlotter", "PCAPlotter", "export_plot"]

_EXPORT_TIMEOUT_S = 300


class _Timeout:
    """SIGALRM watchdog (plot export must never hang a run)."""

    def __init__(self, seconds: int):
        self.seconds = seconds

    def __enter__(self):
        if hasattr(signal, "SIGALRM"):
            self._old = signal.signal(signal.SIGALRM, self._raise)
            signal.alarm(self.seconds)
        return self

    @staticmethod
    def _raise(*_args):
        raise TimeoutError

    def __exit__(self, *exc):
        if hasattr(signal, "SIGALRM"):
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._old)
        return False


class BasePlotter:
    DEFAULTS: Dict[str, Any] = {}

    def __init__(self, params: Dict[str, Any], *args, **kwargs):
        import copy
        # deep-copy the class-level defaults: a shallow dict() would share
        # the nested legend/baselines/histogram dicts across ALL instances,
        # so one caller mutating e.g. plotter.legend['labels'] in place
        # would corrupt every later plotter in a long multi-experiment run
        merged = copy.deepcopy(self.DEFAULTS)
        merged.update(params or {})
        self.params = merged
        for key, value in merged.items():
            setattr(self, key, value)

    # -- shared export paths -------------------------------------------

    def _path(self, extension: str) -> str:
        dirname = getattr(self, "dirname", ".") or "."
        os.makedirs(dirname, exist_ok=True)
        return os.path.join(dirname, f"{getattr(self, 'fname', 'plot')}"
                                     f".{extension}")

    def export_json(self, *args, **kwargs):
        def default(o):
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            if isinstance(o, np.ndarray):
                return o.tolist()
            return str(o)
        with open(self._path("json"), "w") as fh:
            json.dump(self.params, fh, indent=2, default=default)

    def export_matplotlib(self, extension: str = "png", *args, **kwargs):
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        fig = self.render_matplotlib(plt)
        try:
            fig.savefig(self._path(extension), bbox_inches="tight")
        finally:
            # close even when savefig raises (disk full, export timeout):
            # leaked figures accumulate in pyplot's registry over a long
            # multi-experiment run
            plt.close(fig)

    def export_bokeh(self, *args, png_fallback: bool = True, **kwargs):
        """Write the .html; with *png_fallback*, plotters lacking a bokeh
        renderer (or hosts without bokeh) produce a .png instead, so the
        default ``export_plots_as=('json','html')`` always yields an
        artifact.  ``export_plot`` disables the fallback when .png is
        already among the requested formats."""
        try:
            import bokeh  # noqa: F401
        except ImportError:
            if png_fallback:
                warnings.warn("bokeh is not installed; exporting .png "
                              "instead of .html.")
                return self.export_matplotlib("png", *args, **kwargs)
            warnings.warn("bokeh is not installed; skipping .html export.")
            return
        try:
            self.render_bokeh()
        except NotImplementedError:
            if png_fallback:
                warnings.warn(f"{type(self).__name__} has no bokeh "
                              f"renderer; exporting .png instead of .html.")
                self.export_matplotlib("png", *args, **kwargs)

    def render_matplotlib(self, plt):
        raise NotImplementedError

    def render_bokeh(self):
        raise NotImplementedError


class GeneralPlotter(BasePlotter):
    """Line plots of one or more series over a shared x axis."""

    DEFAULTS = {
        "Ys": [],
        "x": None,
        "xlabel": "",
        "ylabel": "",
        "title": "",
        "legend": {"labels": []},
        "baselines": {"labels": [], "values": []},
        "dirname": ".",
        "fname": "plot",
        "yscale": "linear",
        "colors": None,
        "dashes": None,
        # reference plotters.py:258-265: optional distribution overlays
        "histogram": {"labels": [], "Xs": [], "colors": None, "bins": 100,
                      "density": True, "alpha": 0.5},
        "dark": False,  # reference dark_color_settings / dark_minimal theme
    }

    #: bokeh dash names -> matplotlib linestyles
    _DASH_STYLES = {"solid": "-", "dashed": "--", "dotted": ":",
                    "dotdash": "-.", "dashdot": "-."}

    def _series_style(self, i: int) -> dict:
        style = {}
        colors = self.colors or []
        dashes = self.dashes or []
        if i < len(colors) and colors[i]:
            style["color"] = colors[i]
        if i < len(dashes) and dashes[i]:
            style["linestyle"] = self._DASH_STYLES.get(
                str(dashes[i]), dashes[i])
        return style

    def render_matplotlib(self, plt):
        import contextlib
        style = plt.style.context("dark_background") if self.dark \
            else contextlib.nullcontext()  # scoped: no global style leak
        with style:
            return self._render_matplotlib_inner(plt)

    def _render_matplotlib_inner(self, plt):
        fig, ax = plt.subplots(figsize=(8, 5))
        hist = self.histogram or {}
        hist_xs = hist.get("Xs", []) or []
        hist_labels = hist.get("labels", []) or []
        hist_colors = hist.get("colors") or ["grey"]
        for i, xs_h in enumerate(hist_xs):
            ax.hist(list(xs_h), bins=int(hist.get("bins", 100) or 100),
                    density=bool(hist.get("density", True)),
                    alpha=float(hist.get("alpha", 0.5) or 0.5),
                    color=hist_colors[i % len(hist_colors)],
                    label=hist_labels[i] if i < len(hist_labels) else None)
        ys_list = self.Ys or []
        labels = (self.legend or {}).get("labels", []) or []
        for i, ys in enumerate(ys_list):
            xs = self.x if self.x is not None else range(1, len(ys) + 1)
            xs = list(xs)
            if len(xs) != len(ys):
                # short auxiliary series (e.g. the ROC diagonal [0, 1])
                # spans the x range
                lo, hi = (min(xs), max(xs)) if xs else (0.0, 1.0)
                xs = list(np.linspace(lo, hi, len(ys)))
            label = labels[i] if i < len(labels) else None
            ax.plot(xs, list(ys), label=label, **self._series_style(i))
        baselines = self.baselines or {}
        for label, value in zip(baselines.get("labels", []),
                                baselines.get("values", [])):
            ax.axhline(value, linestyle="--", alpha=0.6, label=str(label))
        ax.set_xlabel(self.xlabel)
        ax.set_ylabel(self.ylabel)
        ax.set_yscale(self.yscale)
        if self.title:
            ax.set_title(self.title)
        if any(labels) or baselines.get("labels") or any(hist_labels):
            ax.legend()
        ax.grid(alpha=0.3)
        return fig

    def render_bokeh(self):
        """Full-parity html renderer: series lines plus the baselines,
        histogram overlays and dark mode that ``render_matplotlib``
        renders — html is the DEFAULT export format
        (``config/defaults.py``), so it must not silently drop data the
        png would show."""
        from bokeh.io import output_file, save
        from bokeh.models import Span
        from bokeh.plotting import figure
        fig = figure(title=self.title or "", x_axis_label=self.xlabel,
                     y_axis_label=self.ylabel,
                     y_axis_type="log" if self.yscale == "log" else "linear")
        hist = self.histogram or {}
        hist_xs = hist.get("Xs", []) or []
        hist_labels = hist.get("labels", []) or []
        hist_colors = hist.get("colors") or ["grey"]
        for i, xs_h in enumerate(hist_xs):
            counts, edges = np.histogram(
                np.asarray(list(xs_h), dtype=np.float64),
                bins=int(hist.get("bins", 100) or 100),
                density=bool(hist.get("density", True)))
            kwargs = {}
            if i < len(hist_labels) and hist_labels[i]:
                kwargs["legend_label"] = str(hist_labels[i])
            fig.quad(top=counts, bottom=0, left=edges[:-1],
                     right=edges[1:],
                     fill_color=hist_colors[i % len(hist_colors)],
                     line_color=None,
                     fill_alpha=float(hist.get("alpha", 0.5) or 0.5),
                     **kwargs)
        labels = (self.legend or {}).get("labels", []) or []
        for i, ys in enumerate(self.Ys or []):
            xs = list(self.x) if self.x is not None \
                else list(range(1, len(ys) + 1))
            if len(xs) != len(ys):
                lo, hi = (min(xs), max(xs)) if xs else (0.0, 1.0)
                xs = list(np.linspace(lo, hi, len(ys)))
            kwargs = {"legend_label": labels[i]} if i < len(labels) else {}
            style = self._series_style(i)
            if "color" in style:
                kwargs["line_color"] = style["color"]
            if (self.dashes or []) and i < len(self.dashes) \
                    and self.dashes[i]:
                kwargs["line_dash"] = self.dashes[i]
            fig.line(xs, list(ys), **kwargs)
        baselines = self.baselines or {}
        for label, value in zip(baselines.get("labels", []),
                                baselines.get("values", [])):
            # Span has no legend entry — draw an invisible legend proxy
            # line so the baseline is labelled like the matplotlib axhline
            fig.add_layout(Span(location=float(value), dimension="width",
                                line_dash="dashed", line_alpha=0.6,
                                line_color="grey"))
            fig.line([], [], line_dash="dashed", line_alpha=0.6,
                     line_color="grey", legend_label=str(label))
        if self.dark:
            fig.background_fill_color = "#17181c"
            fig.border_fill_color = "#17181c"
            fig.title.text_color = "#e0e0e0"
            for axis in fig.axis:
                axis.axis_label_text_color = "#e0e0e0"
                axis.major_label_text_color = "#e0e0e0"
                axis.axis_line_color = "#8a8a8a"
                axis.major_tick_line_color = "#8a8a8a"
                axis.minor_tick_line_color = "#555555"
            for grid in fig.grid:
                grid.grid_line_color = "#3a3b40"
            if fig.legend:
                for legend in fig.legend:
                    legend.background_fill_color = "#17181c"
                    legend.label_text_color = "#e0e0e0"
        output_file(self._path("html"))
        save(fig)


class ConfMtxPlotter(BasePlotter):
    """A K x K confusion matrix (rows: ground truth, columns: prediction),
    row-normalised unless ``normalise`` is off; its json holds the raw
    matrix."""

    DEFAULTS = {
        "matrix": [], "labels": None, "title": "", "dirname": ".",
        "fname": "confusion_matrix", "normalise": True,
    }

    def _normalised(self) -> np.ndarray:
        matrix = np.asarray(self.matrix, dtype=np.float64)
        if self.normalise and matrix.size:
            rows = matrix.sum(axis=1, keepdims=True)
            matrix = np.divide(matrix, rows, out=np.zeros_like(matrix),
                               where=rows > 0)
        return matrix

    def _vmax(self, matrix: np.ndarray) -> float:
        # raw counts scale the colour map to their own maximum
        if self.normalise or not matrix.size:
            return 1.0
        return float(max(matrix.max(), 1.0))

    def _cell_text(self, value: float) -> str:
        return f"{value:.2f}" if self.normalise else f"{value:g}"

    def render_matplotlib(self, plt):
        matrix = self._normalised()
        fig, ax = plt.subplots(figsize=(7, 6))
        im = ax.imshow(matrix, cmap="Blues", vmin=0, vmax=self._vmax(matrix))
        fig.colorbar(im, ax=ax)
        labels = self.labels
        if labels and len(labels) <= 10:
            ax.set_xticks(range(len(labels)))
            ax.set_yticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=45, ha="right")
            ax.set_yticklabels(labels)
            for i in range(matrix.shape[0]):
                for j in range(matrix.shape[1]):
                    ax.text(j, i, self._cell_text(matrix[i, j]),
                            ha="center", va="center", fontsize=8)
        ax.set_xlabel("prediction")
        ax.set_ylabel("ground truth")
        if self.title:
            ax.set_title(self.title)
        return fig

    @staticmethod
    def _blues_hex(frac: float) -> str:
        """White-to-blue ramp (in place of the reference's colorcet
        palette, ``plotters.py:929``)."""
        frac = min(1.0, max(0.0, float(frac)))
        r = int(247 - frac * (247 - 8))
        g = int(251 - frac * (251 - 48))
        b = int(255 - frac * (255 - 107))
        return f"#{r:02x}{g:02x}{b:02x}"

    def render_bokeh(self):
        """Annotated heatmap: one coloured rect per cell with its value on
        top, row 0 at the top like the matplotlib image."""
        from bokeh.io import output_file, save
        from bokeh.plotting import figure
        matrix = self._normalised()
        n_rows, n_cols = matrix.shape if matrix.size else (0, 0)
        labels = self.labels or [str(i) for i in range(max(n_rows,
                                                          n_cols))]
        vmax = self._vmax(matrix)
        xs, ys, fills, texts, colors = [], [], [], [], []
        for i in range(n_rows):
            for j in range(n_cols):
                xs.append(j)
                ys.append(n_rows - 1 - i)
                fills.append(self._blues_hex(matrix[i, j] / vmax))
                texts.append(self._cell_text(matrix[i, j]))
                colors.append("#000000" if matrix[i, j] / vmax < 0.6
                              else "#ffffff")
        fig = figure(title=self.title or "", x_axis_label="prediction",
                     y_axis_label="ground truth")
        fig.rect(x=xs, y=ys, width=1, height=1, fill_color=fills,
                 line_color="#cccccc")
        fig.text(x=xs, y=ys, text=texts, text_color=colors,
                 text_align="center", text_baseline="middle",
                 text_font_size="9pt")
        if n_cols and len(labels) >= n_cols:
            fig.xaxis.ticker = list(range(n_cols))
            fig.xaxis.major_label_overrides = {
                j: str(labels[j]) for j in range(n_cols)}
        if n_rows and len(labels) >= n_rows:
            fig.yaxis.ticker = list(range(n_rows))
            fig.yaxis.major_label_overrides = {
                n_rows - 1 - i: str(labels[i]) for i in range(n_rows)}
        output_file(self._path("html"))
        save(fig)


#: bokeh legend locations -> matplotlib loc strings
_LEGEND_LOCS = {"top_left": "upper left", "top_right": "upper right",
                "bottom_left": "lower left", "bottom_right": "lower right"}


def _alpha(opacity) -> float:
    """The reference's opacity: point alpha = 1 - opacity, within [0.05,
    1]."""
    return min(1.0, max(0.05, 1.0 - float(opacity or 0)))


def _place_bokeh_legend(fig, legend) -> None:
    loc = (legend or {}).get("location", "bottom_right")
    for item in fig.legend:
        item.location = loc


class ScatterPlotter(BasePlotter):
    """Scatter plot(s): multi-series ``Xs``/``Ys`` (or one ``x``/``y``
    series), the 45-degree line (``line45_color``, None leaves it out), a
    deterministic x jitter per series, the reference's opacity, circle size
    and a placeable legend."""

    DEFAULTS = {
        "x": [], "y": [], "Xs": None, "Ys": None,
        "xlabel": "", "ylabel": "", "title": "",
        "dirname": ".", "fname": "scatter", "labels": None,
        "line45_color": None, "circle_size": 10, "x_jitter": 0,
        "opacity": 0, "colors": None,
        "legend": {"labels": [], "location": "bottom_right"},
    }

    def _series(self):
        """[(x, y), ...] float64 arrays, one pair per series."""
        xs, ys = self.Xs, self.Ys
        if xs is None or ys is None:
            xs, ys = [self.x], [self.y]
        elif len(xs) and np.ndim(xs[0]) == 0:
            xs, ys = [xs], [ys]
        return [(np.asarray(x, np.float64), np.asarray(y, np.float64))
                for x, y in zip(xs, ys)]

    def _labels(self, n: int):
        labels = (self.legend or {}).get("labels", []) or self.labels or []
        return [labels[i] if i < len(labels) else None for i in range(n)]

    def _jittered(self, x: np.ndarray, i: int) -> np.ndarray:
        if not self.x_jitter:
            return x
        # seeded by the series index: a re-export draws the same points
        rng = np.random.default_rng(i)
        return x + rng.uniform(-0.5, 0.5, x.shape) * float(self.x_jitter)

    def _x_range(self, series):
        xs = [x for x, _ in series if len(x)]
        if not xs:
            return 0.0, 1.0
        return (float(min(x.min() for x in xs)),
                float(max(x.max() for x in xs)))

    def render_matplotlib(self, plt):
        fig, ax = plt.subplots(figsize=(7, 6))
        series = self._series()
        labels = self._labels(len(series))
        if self.line45_color:
            lo, hi = self._x_range(series)
            ax.plot([lo, hi], [lo, hi], color=self.line45_color, zorder=1)
        colors = self.colors or []
        for i, (x, y) in enumerate(series):
            ax.scatter(self._jittered(x, i), y, s=self.circle_size,
                       alpha=_alpha(self.opacity), label=labels[i],
                       color=colors[i] if i < len(colors) else None)
        ax.set_xlabel(self.xlabel)
        ax.set_ylabel(self.ylabel)
        if self.title:
            ax.set_title(self.title)
        if any(labels):
            loc = (self.legend or {}).get("location", "bottom_right")
            ax.legend(loc=_LEGEND_LOCS.get(loc, "best"))
        ax.grid(alpha=0.3)
        return fig

    def render_bokeh(self):
        from bokeh.io import output_file, save
        from bokeh.plotting import figure
        fig = figure(title=self.title or "", x_axis_label=self.xlabel,
                     y_axis_label=self.ylabel)
        series = self._series()
        labels = self._labels(len(series))
        if self.line45_color:
            lo, hi = self._x_range(series)
            fig.line([lo, hi], [lo, hi], line_color=self.line45_color,
                     line_width=2)
        colors = self.colors or []
        for i, (x, y) in enumerate(series):
            kwargs = {}
            if labels[i]:
                kwargs["legend_label"] = str(labels[i])
            if i < len(colors) and colors[i]:
                kwargs["color"] = colors[i]
            fig.scatter(list(self._jittered(x, i)), list(y),
                        size=self.circle_size, alpha=_alpha(self.opacity),
                        **kwargs)
        if any(labels) and fig.legend:
            _place_bokeh_legend(fig, self.legend)
        output_file(self._path("html"))
        save(fig)


class PCAPlotter(BasePlotter):
    """A 2-D PCA scatter of one or more vector sets, and their export in
    the TensorFlow projector's tsv format (``export_tsv``)."""

    DEFAULTS = {
        "vectors": [], "labels": None, "title": "", "xlabel": "x",
        "ylabel": "y", "dirname": ".", "fname": "PCA_plot",
        "legend": {"labels": [], "location": "bottom_right"},
        "circle_size": 15, "opacity": 0.2,
    }

    def _groups(self):
        vectors = self.vectors
        if vectors and not isinstance(vectors[0][0], (list, np.ndarray)):
            vectors = [vectors]
        return [np.asarray(group, np.float64) for group in vectors]

    def _project(self):
        """Each group on the first two principal axes of all the vectors
        together (numpy's SVD of the centred stack, so the axes' signs are
        the JAX package's)."""
        groups = self._groups()
        stacked = np.concatenate(groups, axis=0)
        centred = stacked - stacked.mean(axis=0, keepdims=True)
        _, _, vt = np.linalg.svd(centred, full_matrices=False)
        projected = centred @ vt[:2].T
        out, start = [], 0
        for group in groups:
            out.append(projected[start:start + len(group)])
            start += len(group)
        return out

    def _legend_labels(self):
        return (self.legend or {}).get("labels", []) or []

    def render_matplotlib(self, plt):
        fig, ax = plt.subplots(figsize=(8, 6))
        labels = self._legend_labels()
        for i, pts in enumerate(self._project()):
            ax.scatter(pts[:, 0], pts[:, 1], s=self.circle_size,
                       alpha=_alpha(self.opacity),
                       label=labels[i] if i < len(labels) else None)
        ax.set_xlabel(self.xlabel)
        ax.set_ylabel(self.ylabel)
        if self.title:
            ax.set_title(self.title)
        if labels:
            loc = (self.legend or {}).get("location", "bottom_right")
            ax.legend(loc=_LEGEND_LOCS.get(loc, "best"))
        ax.grid(alpha=0.3)
        return fig

    def render_bokeh(self):
        from bokeh.io import output_file, save
        from bokeh.plotting import figure
        fig = figure(title=self.title or "", x_axis_label=self.xlabel,
                     y_axis_label=self.ylabel)
        labels = self._legend_labels()
        for i, pts in enumerate(self._project()):
            kwargs = {}
            if i < len(labels) and labels[i]:
                kwargs["legend_label"] = str(labels[i])
            fig.scatter(list(pts[:, 0]), list(pts[:, 1]),
                        size=self.circle_size, alpha=_alpha(self.opacity),
                        **kwargs)
        if labels and fig.legend:
            _place_bokeh_legend(fig, self.legend)
        output_file(self._path("html"))
        save(fig)

    def export_tsv(self):
        """``<fname>_vectors.tsv`` (one vector per line) and
        ``<fname>_metadata.tsv`` (its group's legend label)."""
        groups = self._groups()
        labels = self._legend_labels()
        base = self._path("tsv")[:-4]
        with open(base + "_vectors.tsv", "w") as fh:
            for group in groups:
                for vec in group:
                    fh.write("\t".join(str(float(v)) for v in vec) + "\n")
        with open(base + "_metadata.tsv", "w") as fh:
            for i, group in enumerate(groups):
                name = labels[i] if i < len(labels) else f"group_{i}"
                fh.writelines(f"{name}\n" for _ in range(len(group)))


def export_plot(plotter: BasePlotter, extensions: Iterable[str],
                *args, **kwargs) -> None:
    """Export a plotter to each requested format, non-fatally.  Under data
    parallelism only the main process writes: every process holds the same
    plot."""
    from ..parallel import is_main_process
    if not is_main_process():
        return
    # materialize up front: a generator argument would be exhausted by the
    # `requested` set and the loop below would silently export nothing
    normalized = [str(e).lower().strip(".") for e in extensions]
    requested = set(normalized)
    export_funcs = {
        "json": plotter.export_json,
        "png": lambda *a, **k: plotter.export_matplotlib("png", *a, **k),
        "svg": lambda *a, **k: plotter.export_matplotlib("svg", *a, **k),
        # don't render the png twice when it's already requested alongside
        "html": lambda *a, **k: plotter.export_bokeh(
            *a, png_fallback="png" not in requested, **k),
    }
    for ext in normalized:
        func = export_funcs.get(ext)
        if func is None:
            warnings.warn(f"Unknown plot format {ext!r}")
            continue
        # one watchdog per format: SIGALRM is one-shot, so a single alarm
        # around the whole loop would leave every format after the first
        # timeout unprotected
        try:
            with _Timeout(_EXPORT_TIMEOUT_S):
                func(*args, **kwargs)
        except TimeoutError:
            warnings.warn(f".{ext} plot export timed out; continuing.")
        except Exception as exc:  # noqa: BLE001
            handle_exception(exc, f"Exception exporting plot as .{ext}.")
