"""Plotting: metric-history curves and confusion matrices exported as
json, png, svg or html."""
from .plotters import BasePlotter, ConfMtxPlotter  # noqa: F401
from .plotters import GeneralPlotter, export_plot  # noqa: F401

__all__ = ["BasePlotter", "GeneralPlotter", "ConfMtxPlotter", "export_plot"]
