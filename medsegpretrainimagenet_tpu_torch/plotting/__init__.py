"""Plotting: metric-history curves exported as json, png, svg or html."""
from .plotters import BasePlotter, GeneralPlotter, export_plot  # noqa: F401

__all__ = ["BasePlotter", "GeneralPlotter", "export_plot"]
