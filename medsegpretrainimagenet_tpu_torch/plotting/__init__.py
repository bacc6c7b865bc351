"""Plotting: metric-history curves, confusion matrices, scatter and PCA
plots exported as json, png, svg or html (and the PCA vectors as tsv)."""
from .plotters import BasePlotter, ConfMtxPlotter  # noqa: F401
from .plotters import GeneralPlotter, PCAPlotter  # noqa: F401
from .plotters import ScatterPlotter, export_plot  # noqa: F401

__all__ = ["BasePlotter", "GeneralPlotter", "ConfMtxPlotter",
           "ScatterPlotter", "PCAPlotter", "export_plot"]
