"""The port's last two plotters, ``ScatterPlotter`` and ``PCAPlotter``,
against the JAX package's on the same numpy inputs: their json and tsv
files are byte for byte the JAX plotters', the PCA projection (numpy's SVD)
is the same array, and the matplotlib points and the bokeh glyph records
(``tests/fake_bokeh.py``) are the same."""
import json
import pathlib

import numpy as np
import pytest

from medsegpretrainimagenet_tpu.plotting import PCAPlotter as JaxPCAPlotter
from medsegpretrainimagenet_tpu.plotting import \
    ScatterPlotter as JaxScatterPlotter
from medsegpretrainimagenet_tpu_torch.plotting import (PCAPlotter,
                                                       ScatterPlotter,
                                                       export_plot)


def _scatter_params(case):
    rng = np.random.default_rng(0)
    if case == "single":
        return {"x": [1, 2, 3], "y": [2.5, 1.0, 0.5], "title": "t"}
    return {"Xs": [rng.random(5), rng.random(4) * 2],
            "Ys": [rng.random(5).tolist(), rng.random(4).tolist()],
            "xlabel": "ground truth", "ylabel": "prediction",
            "line45_color": "black", "x_jitter": 0.3, "opacity": 0.4,
            "colors": ["red", None],
            "legend": {"labels": ["a", "b"], "location": "top_left"}}


def _pca_params():
    rng = np.random.default_rng(1)
    return {"vectors": [rng.normal(size=(6, 5)),
                        (rng.normal(size=(4, 5)) + 3).tolist()],
            "legend": {"labels": ["g1"], "location": "bottom_left"},
            "title": "pca"}


def _files(plot, write, names):
    """Write *plot*'s files with *write* and return their bytes."""
    write(plot)
    return {name: (pathlib.Path(plot.dirname) / name).read_bytes()
            for name in names}


def _both(make_jax, make_port, params, tmp_path):
    """Both packages' plotters on the same parameters and directory (the
    json holds the directory)."""
    params = dict(params, dirname=str(tmp_path))
    return make_jax(dict(params)), make_port(dict(params))


@pytest.mark.parametrize("case", ["single", "multi"])
def test_scatter_json_equals_jax(tmp_path, case):
    jax_plot, port_plot = _both(JaxScatterPlotter, ScatterPlotter,
                                _scatter_params(case), tmp_path)
    names = ["scatter.json"]
    want = _files(jax_plot, lambda p: p.export_json(), names)
    got = _files(port_plot, lambda p: p.export_json(), names)
    assert got == want
    assert json.loads(got["scatter.json"])["legend"]["labels"] == (
        ["a", "b"] if case == "multi" else [])


def test_pca_json_tsv_and_projection_equal_jax(tmp_path):
    jax_plot, port_plot = _both(JaxPCAPlotter, PCAPlotter, _pca_params(),
                                tmp_path)
    names = ["PCA_plot.json", "PCA_plot_vectors.tsv",
             "PCA_plot_metadata.tsv"]

    def write(plot):
        plot.export_json()
        plot.export_tsv()
    want = _files(jax_plot, write, names)
    got = _files(port_plot, write, names)
    for name in names:
        assert got[name] == want[name], name
    assert got["PCA_plot_metadata.tsv"].decode().split() \
        == ["g1"] * 6 + ["group_1"] * 4
    for got, want in zip(port_plot._project(), jax_plot._project()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["scatter", "pca"])
def test_matplotlib_points_equal_jax(tmp_path, kind):
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    if kind == "scatter":
        pair = _both(JaxScatterPlotter, ScatterPlotter,
                     _scatter_params("multi"), tmp_path)
    else:
        pair = _both(JaxPCAPlotter, PCAPlotter, _pca_params(), tmp_path)
    figures = [plot.render_matplotlib(plt) for plot in pair]
    try:
        (jax_ax,), (port_ax,) = (fig.axes for fig in figures)
        assert len(port_ax.collections) == len(jax_ax.collections) == 2
        for got, want in zip(port_ax.collections, jax_ax.collections):
            np.testing.assert_array_equal(got.get_offsets(),
                                          want.get_offsets())
            np.testing.assert_array_equal(got.get_alpha(), want.get_alpha())
        assert [t.get_text() for t in port_ax.get_legend().get_texts()] \
            == [t.get_text() for t in jax_ax.get_legend().get_texts()]
    finally:
        for fig in figures:
            plt.close(fig)


@pytest.mark.parametrize("kind", ["scatter", "pca"])
def test_bokeh_glyphs_equal_jax(tmp_path, kind):
    import fake_bokeh
    if kind == "scatter":
        jax_plot, port_plot = _both(JaxScatterPlotter, ScatterPlotter,
                                    _scatter_params("multi"), tmp_path)
        names = ["scatter.html"]
    else:
        jax_plot, port_plot = _both(JaxPCAPlotter, PCAPlotter,
                                    _pca_params(), tmp_path)
        names = ["PCA_plot.html"]
    fake_bokeh.install()
    try:
        want = _files(jax_plot, lambda p: p.render_bokeh(), names)
        got = _files(port_plot, lambda p: p.render_bokeh(), names)
    finally:
        fake_bokeh.uninstall()
    assert got == want


def test_export_plot_writes_json_and_png(tmp_path):
    plot = PCAPlotter(dict(_pca_params(), dirname=str(tmp_path),
                           fname="p"))
    export_plot(plot, ["json", "png"])
    assert (tmp_path / "p.json").is_file() and (tmp_path / "p.png").is_file()
