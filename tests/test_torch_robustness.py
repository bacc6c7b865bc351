"""The port's transferability sweep held against the JAX package's on the
CPU, on the same numpy inputs and weights.

* The distances and the margin scorer within 1e-6 relative.
* The color jitter on JAX's own draws (the same ``jax.random`` calls as
  ``robustness/eval.py:98-107``, replayed) within 1e-5 absolute, for every
  order of the four ops, on 1- and 3-channel images; the HSV maps.
* Per-level activations of the paper's three encoder families (U-Net
  encoder, ResNet, Swin encoder at a small size) within 1e-5.
* ``run_sweep`` rows against JAX's ``run_sweep`` on the injected draws
  within 1e-5; level skipping, ``adapt_channels`` and the same views for
  every encoder.
* The CLI with ``--device cpu`` on a tiny probe tree, with reference-named
  weights for all three families, against the JAX CLI's CSV within 1e-4.

Threefry and Philox never give equal draws, so the port's sweep takes
JAX's draws wherever it is compared with JAX."""
import csv
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from medsegpretrainimagenet_tpu.config import ConfigDict as JaxConfigDict
from medsegpretrainimagenet_tpu.config import registry as jax_registry
from medsegpretrainimagenet_tpu.models import Model as JaxModel
from medsegpretrainimagenet_tpu.robustness import distances as jax_dist
from medsegpretrainimagenet_tpu.robustness import eval as jax_eval
from medsegpretrainimagenet_tpu.robustness import sweep as jax_sweep
from medsegpretrainimagenet_tpu.robustness.__main__ import main as jax_main
from medsegpretrainimagenet_tpu_torch.config import ConfigDict
from medsegpretrainimagenet_tpu_torch.robustness import distances, sweep
from medsegpretrainimagenet_tpu_torch.robustness import eval as port_eval
from medsegpretrainimagenet_tpu_torch.robustness.__main__ import (
    build_encoders, main)
from medsegpretrainimagenet_tpu_torch.train.checkpoint import save_params_file

from torch_port_helpers import reference_state, transplant

SIZE, N_PROBES = 32, 8
LEVEL_TOL, ROW_TOL, CLI_TOL = 1e-5, 1e-5, 1e-4
ORDERS = list(itertools.permutations(range(4)))


def jax_replayed_draws(key, brightness=0.1, contrast=0.05, saturation=0.1,
                       hue=0.05):
    """The draws of the JAX ``color_jitter(key, ...)``: the same
    ``jax.random`` calls on the same key."""
    keys = jax.random.split(key, 5)
    order = jax.random.permutation(keys[0], 4)
    b = jax.random.uniform(keys[1], (), minval=1 - brightness,
                           maxval=1 + brightness)
    c = jax.random.uniform(keys[2], (), minval=1 - contrast,
                           maxval=1 + contrast)
    s = jax.random.uniform(keys[3], (), minval=1 - saturation,
                           maxval=1 + saturation)
    h = jax.random.uniform(keys[4], (), minval=-hue, maxval=hue)
    return port_eval.JitterDraws(tuple(int(i) for i in order), float(b),
                                 float(c), float(s), float(h))


def jax_dataset_draws(seed, ds_index):
    """JAX ``run_sweep``'s two views of dataset *ds_index*, replayed."""
    k0, k1 = jax.random.split(jax.random.fold_in(jax.random.key(seed),
                                                 ds_index))
    return jax_replayed_draws(k0), jax_replayed_draws(k1)


def encoder_configs(size=SIZE):
    """The three encoder families of ``tools/robustness_tpu.py``, cut to a
    small size: 4 activation levels of the U-Net encoder and the ResNet, 3
    of the Swin encoder (2 levels of 2 blocks and the bottom, window 2)."""
    return [
        {"name": "u-net_encoder", "pretraining_scheme": "simple_training",
         "pretraining_length": 3,
         "model": {"segmentation.models.UNet_encoder": {
             "in_channel_size": 3, "channels": (4, 8, 16, 32),
             "depth": 3}}},
        {"name": "resnet50", "pretraining_scheme": "simple_training",
         "pretraining_length": 0,
         "model": {"classification.models.DeepResNet": {
             "bias": False, "version": "v1", "channel_sizes": (16, 32, 64),
             "widths": (1, 1, 1), "base_channel_size": 8}}},
        {"name": "swin_transformer", "pretraining_scheme": "simple_training",
         "pretraining_length": 0,
         "model": {"segmentation.models.UNet_encoder": {
             "in_channel_size": 3, "channels": (8, 16, 32),
             "change_channel_in_block": False, "depth": 2, "width": 2,
             "trainable_downsampling": True, "linear_channel_mapping": True,
             "stochastic_depth_rate": 0.1,
             "basic_block": {
                 "segmentation.models.blocks.SwinTransformerBlock": {
                     "img_size": size, "patch_size": 4, "embed_dim": 8,
                     "num_heads_layers": (1, 2, 4), "window_size": 2}},
             "downsampling": {"segmentation.models.blocks.PatchMerging": {
                 "norm_layer": "torch.nn.LayerNorm"}},
             "stem": {"segmentation.models.blocks.PatchEmbed": {
                 "patch_size": 4}}}}},
    ]


FAMILIES = {"u-net_encoder": "unet", "resnet50": "resnet",
            "swin_transformer": "swin"}


def _probes(channels=1, n=N_PROBES, seed=0):
    return np.random.default_rng(seed).random(
        (n, SIZE, SIZE, channels)).astype(np.float32)


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX encoder dict (module, variables with marked
    BatchNorm statistics, metadata) and the port's, the same weights."""
    from medsegpretrainimagenet_tpu.predict import (
        _model_in_channels as jax_in_channels)

    probes = _probes()
    cfg = ConfigDict({"encoders": encoder_configs()})
    port = build_encoders(cfg, {"probe": probes}, 0, torch.device("cpu"))
    out = {}
    for enc_cfg, port_enc in zip(JaxConfigDict(
            {"encoders": encoder_configs()}).elements_of("encoders"), port):
        model = jax_registry.build(enc_cfg["model"].trim(), wrapper=JaxModel)
        want = jax_in_channels(enc_cfg) or getattr(
            model.module, "in_channel_size", None)
        sample = np.asarray(jax_sweep.adapt_channels(probes[:1], want))
        variables = jax.tree_util.tree_map(np.asarray, model.init(
            jax.random.key(1), {"x": sample}))
        rng = np.random.default_rng(2)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, v: (rng.uniform(0.5, 1.5, v.shape)
                             if path[-1].key == "var" else
                             rng.normal(0.0, 0.1, v.shape)).astype(np.float32),
            variables.get("batch_stats", {}))
        transplant(variables, port_enc["module"])
        assert port_enc["in_channels"] == want
        name = enc_cfg["name"]
        out[name] = ({"module": model.module, "variables": variables,
                      "name": name, "in_channels": want,
                      "pretraining_scheme": enc_cfg["pretraining_scheme"],
                      "pretraining_length": enc_cfg["pretraining_length"]},
                     port_enc)
    return out


# ---------------------------------------------------------------------------
# distances and the scorer
# ---------------------------------------------------------------------------

def test_distance_table_matches_jax():
    assert set(distances.DISTANCES) == set(jax_dist.DISTANCES)
    for name, fn in distances.DISTANCES.items():
        assert fn.__name__ == jax_dist.DISTANCES[name].__name__


@pytest.mark.parametrize("name", ["cosine_distance", "l2_loss",
                                  "inv_pearson_corr"])
def test_distances_match_jax(name):
    rng = np.random.default_rng(1)
    x, y = (rng.normal(size=(6, 40)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_dist.DISTANCES[name](jnp.asarray(x),
                                               jnp.asarray(y)))
    got = distances.DISTANCES[name](torch.from_numpy(x),
                                    torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [6, 7])
@pytest.mark.parametrize("margin", [0.0, 0.5, 1.0])
def test_scorer_matches_jax(n, margin):
    """Negatives reversed and rolled by 2; an odd N keeps the reference's
    self-match.  A score is a difference of two distances of order 1, so
    it is held within 1e-6 of them, absolute."""
    rng = np.random.default_rng(n)
    p0, p1 = (rng.normal(size=(n, 3, 3, 4)).astype(np.float32)
              for _ in range(2))
    for name in ("cosine_distance", "l2", "inv_pearson"):
        want = np.asarray(jax_eval.Robustness(jax_dist.DISTANCES[name],
                                              margin)(p0, p1))
        got = port_eval.Robustness(distances.DISTANCES[name], margin)(
            torch.from_numpy(p0), torch.from_numpy(p1)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the color jitter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keys_by_order():
    """For each of the 24 op orders, a JAX key whose color jitter draws it
    (found by trying keys in turn)."""
    found = {}
    seed = 0
    while len(found) < len(ORDERS):
        key = jax.random.key(seed)
        found.setdefault(jax_replayed_draws(key).order, key)
        seed += 1
    return found


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("order", range(len(ORDERS)))
def test_color_jitter_on_jax_draws(keys_by_order, order, channels):
    key = keys_by_order[ORDERS[order]]
    imgs = np.random.default_rng(order).random(
        (2, 6, 5, channels)).astype(np.float32)
    want = np.asarray(jax_eval.color_jitter(key, jnp.asarray(imgs)))
    draws = jax_replayed_draws(key)
    assert draws.order == ORDERS[order]
    got = port_eval.apply_color_jitter(torch.from_numpy(imgs), draws)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if channels == 1:   # no hue, and saturation is the identity
        assert not np.array_equal(got.numpy(), imgs)


def test_hsv_maps_match_jax_and_round_trip():
    rgb = np.random.default_rng(5).random((4, 7, 7, 3)).astype(np.float32)
    rgb[0, 0, 0] = 0.25             # grey: no hue
    rgb[0, 0, 1] = (0.0, 0.0, 0.0)  # black: no saturation
    hsv = port_eval._rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(
        hsv.numpy(), np.asarray(jax_eval._rgb_to_hsv(jnp.asarray(rgb))),
        atol=1e-6, rtol=0)
    assert float(hsv[..., 0].min()) >= 0 and float(hsv[..., 0].max()) < 1
    back = port_eval._hsv_to_rgb(hsv)
    np.testing.assert_allclose(
        back.numpy(),
        np.asarray(jax_eval._hsv_to_rgb(jax_eval._rgb_to_hsv(
            jnp.asarray(rgb)))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-6, rtol=0)


def test_jitter_draws_are_seeded_and_in_range():
    draws = [port_eval.jitter_draws(torch.Generator().manual_seed(s))
             for s in range(40)]
    assert draws[0] == port_eval.jitter_draws(
        torch.Generator().manual_seed(0))
    for d in draws:
        assert sorted(d.order) == [0, 1, 2, 3]
        assert 0.9 <= d.brightness <= 1.1 and 0.95 <= d.contrast <= 1.05
        assert 0.9 <= d.saturation <= 1.1 and -0.05 <= d.hue <= 0.05
        assert all(np.float32(v) == v for v in d[1:])
    assert len({d.order for d in draws}) > 10
    a0, a1 = sweep.dataset_draws(0, 0)
    assert a0 != a1 and sweep.dataset_draws(0, 0) == (a0, a1)
    assert sweep.dataset_draws(0, 1) != (a0, a1)
    assert sweep.dataset_draws(1, 0) != (a0, a1)


# ---------------------------------------------------------------------------
# levels of the three encoder families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_levels_match_jax(families, name):
    jax_enc, port_enc = families[name]
    probes = _probes(seed=3)
    x = np.array(jax_sweep.adapt_channels(probes, jax_enc["in_channels"]))
    want = jax_eval.collect_levels(jax_enc["module"], jax_enc["variables"],
                                   jnp.asarray(x), batch_size=4)
    got = port_eval.collect_levels(port_enc["module"], torch.from_numpy(x),
                                   batch_size=4)
    assert len(got) == len(want) == (3 if name == "swin_transformer" else 4)
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, level
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LEVEL_TOL,
                                   atol=LEVEL_TOL, err_msg=f"level {level}")
    assert not port_enc["module"].training
    pooled = port_eval.predict_w_model(port_enc["module"],
                                       torch.from_numpy(x), batch_size=4,
                                       level=1, pool=True)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(
        jax_eval.pool_spatial(want[1])), rtol=LEVEL_TOL, atol=LEVEL_TOL)


def test_eval_encoder_matches_jax(families):
    jax_enc, port_enc = families["u-net_encoder"]
    x = np.repeat(_probes(seed=4), 3, axis=-1)
    key = jax.random.key(7)
    want = jax_eval.eval_encoder(
        jax_enc["module"], jax_enc["variables"], x,
        jax_eval.Robustness(jax_dist.l2_loss, 0.5), level=2, pool=False,
        key=key, batch_size=4)
    got = port_eval.eval_encoder(
        port_enc["module"], x, port_eval.Robustness(distances.l2_loss, 0.5),
        level=2, pool=False, batch_size=4,
        draws=[jax_replayed_draws(k) for k in jax.random.split(key)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROW_TOL,
                               atol=ROW_TOL)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

SWEEP_AXES = dict(metrics=("cosine_distance", "l2_loss", "inv_pearson_corr"),
                  margins=(0.0, 0.25, 1.0), levels=(1, 2, 3, 4),
                  pooled=(False, True), batch_size=4, seed=3)


def _assert_rows_match(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "robustness"} == \
            {k: v for k, v in w.items() if k != "robustness"}
        assert np.isclose(float(g["robustness"]), float(w["robustness"]),
                          rtol=0, atol=tol, equal_nan=True), (g, w)


@pytest.mark.parametrize("probes", ["gray", "rgb"])
def test_run_sweep_matches_jax_on_its_draws(families, probes):
    """Two datasets of 1-channel probes through all three encoders, or of
    3-channel probes (hue and saturation act) through the two encoders
    that take 3 channels (the ResNet's stem is sized for 1)."""
    names = list(FAMILIES) if probes == "gray" \
        else ["u-net_encoder", "swin_transformer"]
    channels = 1 if probes == "gray" else 3
    datasets = {f"{probes}_{i}": _probes(channels=channels, seed=5 + i)
                for i in range(2)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_sweep.run_sweep([families[n][0] for n in names],
                                   datasets, **SWEEP_AXES)
    draws = {name: jax_dataset_draws(SWEEP_AXES["seed"], i)
             for i, name in enumerate(datasets)}
    with pytest.warns(UserWarning, match="swin_transformer.*skipping "
                                         r"requested levels \[3, 4\]"):
        got = sweep.run_sweep([families[n][1] for n in names], datasets,
                              draws=draws, **SWEEP_AXES)
    # 2 datasets x 3 metrics x 3 margins x 2 pooled x the encoders' levels
    # (3 of the U-Net encoder and the ResNet, 2 of the Swin encoder)
    assert len(got) == 2 * 3 * 3 * 2 * (8 if probes == "gray" else 5)
    _assert_rows_match(got, want, ROW_TOL)
    assert all(np.isfinite(r["robustness"]) for r in got)


@pytest.mark.parametrize("have, want", [(1, 3), (3, 1), (1, None), (3, 3)])
def test_adapt_channels_matches_jax(have, want):
    """A repeat is exact; a mean over 3 channels within its rounding."""
    imgs = _probes(channels=have, n=2)
    np.testing.assert_allclose(
        sweep.adapt_channels(torch.from_numpy(imgs), want).numpy(),
        np.asarray(jax_sweep.adapt_channels(jnp.asarray(imgs), want)),
        rtol=1e-6, atol=0)


def test_adapt_channels_refuses_what_it_cannot_map():
    with pytest.raises(ValueError, match="cannot adapt"):
        sweep.adapt_channels(torch.zeros(1, 2, 2, 3), 4)


def test_every_encoder_sees_the_same_views(families):
    """The draws depend on (seed, dataset) alone: every encoder gets the
    same two views, adapted to its channel count after the jitter."""
    seen = {}

    def recording(name, module):
        def forward(x):
            seen.setdefault(name, []).append(x.clone())
            return module(x, return_skip_vals=True)
        return forward

    encoders = []
    for name in ("u-net_encoder", "resnet50"):
        enc = dict(families[name][1])
        enc["method"] = recording(name, enc["module"])
        encoders.append(enc)
    sweep.run_sweep(encoders, {"gray": _probes(seed=8)},
                    metrics=("l2",), margins=(0.0,), levels=(1,),
                    pooled=(True,), batch_size=N_PROBES, seed=4)
    unet_views, resnet_views = seen["u-net_encoder"], seen["resnet50"]
    assert len(unet_views) == len(resnet_views) == 2
    for rgb, gray in zip(unet_views, resnet_views):
        assert gray.shape[-1] == 1 and rgb.shape[-1] == 3
        assert torch.equal(rgb, gray.repeat_interleave(3, dim=-1))
    assert not torch.equal(resnet_views[0], resnet_views[1])
    draws = sweep.dataset_draws(4, 0)
    probes = torch.from_numpy(_probes(seed=8))
    for view, d in zip(resnet_views, draws):
        assert torch.equal(view, port_eval.apply_color_jitter(probes, d))


def test_levels_beyond_an_encoder_are_skipped_with_a_warning(families):
    port_enc = families["swin_transformer"][1]
    with pytest.warns(UserWarning, match=r"3 activation levels; skipping "
                                         r"requested levels \[3, -4\]"):
        rows = sweep.run_sweep([port_enc], {"gray": _probes(seed=9)},
                               metrics=("l2",), margins=(0.5,),
                               levels=(2, 3, -1, -4), pooled=(True,),
                               batch_size=N_PROBES)
    assert [r["level"] for r in rows] == [2, -1]


def test_write_scores_csv_has_the_jax_columns(tmp_path):
    rows = [{"dataset": "d", "metric": "l2", "margin": 0.5, "encoder": "e",
             "pretraining_scheme": "none", "pooled": True, "level": 1,
             "pretraining_length": 0, "robustness": 0.25}]
    sweep.write_scores_csv(str(tmp_path / "port.csv"), rows)
    jax_sweep.write_scores_csv(str(tmp_path / "jax.csv"), rows)
    assert sweep.CSV_COLUMNS == jax_sweep.CSV_COLUMNS
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def write_probe_tree(root, n=N_PROBES, size=SIZE, seed=0):
    """A synthetic COVID-QU tree, as ``tools/robustness_tpu.py`` writes."""
    rng = np.random.default_rng(seed)
    base = root / "COVID_QU" / "Inf_segm" / "data arrays" / "COVID-19"
    for part, count in (("train and val", n), ("test", 2)):
        d = base / part
        d.mkdir(parents=True)
        np.save(d / "imgs.npy", rng.integers(0, 256, (count, 1, size, size),
                                             dtype=np.uint8))
        masks = np.zeros((count, 1, size, size), np.uint8)
        masks[:, :, size // 4:-size // 4, size // 4:-size // 4] = 2
        np.save(d / "inf_masks.npy", masks)


def sweep_config(out, encoders, n=N_PROBES):
    return {
        "data": {"COVID-QU": {"segmentation.datasets.COVIDQUDataset": {
            "lung_or_infection": "inf", "image_sizes": SIZE,
            "validate_on_test": True}}},
        "probe_images": n, "encoders": encoders,
        "metrics": ["cosine_distance", "l2_loss", "inv_pearson_corr"],
        "margins": [0.0, 0.25, 0.5, 0.75, 1.0], "levels": [1, 2, 3, 4],
        "pooled": [False, True], "batch_size": 4, "output": str(out),
        "seed": 0}


def _read_csv(path):
    with open(path) as fh:
        reader = csv.DictReader(fh)
        return reader.fieldnames, list(reader)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, families):
    """Both CLIs on one probe tree, each encoder's ``weights`` a
    reference-named torch state dict written from the port encoder's
    weights (the JAX ones transplanted), draws injected into the port."""
    root = tmp_path_factory.mktemp("robustness")
    write_probe_tree(root / "data")
    encoders = encoder_configs()
    for enc in encoders:
        module = families[enc["name"]][1]["module"]
        path = root / f"{enc['name']}.pt"
        save_params_file(str(path), reference_state(
            module.state_dict(), FAMILIES[enc["name"]]))
        enc["weights"] = str(path)
    mp = pytest.MonkeyPatch()
    mp.setenv("MST_DATA_DIR", str(root / "data"))
    mp.setattr(sweep, "dataset_draws", jax_dataset_draws)
    outputs = {}
    try:
        for which, run in (("jax", jax_main), ("port", main)):
            cfg_path = root / f"{which}.yaml"
            cfg_path.write_text(yaml.safe_dump(sweep_config(
                root / f"{which}.csv", encoders)))
            argv = [str(cfg_path)] + (["--device", "cpu"]
                                      if which == "port" else [])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                import contextlib
                import io
                buffer = io.StringIO()
                with contextlib.redirect_stdout(buffer):
                    assert run(argv) == 0
            outputs[which] = buffer.getvalue()
    finally:
        mp.undo()
    return root, outputs


def test_cli_csv_matches_jax(cli_runs):
    root, outputs = cli_runs
    port_header, port_rows = _read_csv(root / "port.csv")
    jax_header, jax_rows = _read_csv(root / "jax.csv")
    assert port_header == jax_header == list(jax_sweep.CSV_COLUMNS)
    # 3 metrics x 5 margins x 2 pooled x (3 + 3 + 2 levels)
    assert len(port_rows) == 240
    _assert_rows_match(port_rows, jax_rows, CLI_TOL)
    assert "wrote 240 rows" in outputs["port"]
    for text in outputs.values():
        for word in ("unmapped", "left random", "unused"):
            assert word not in text, text


def test_cli_rows_come_from_the_weights(cli_runs, tmp_path, monkeypatch):
    """Without ``weights`` every family scores other values: the files
    were loaded, not left as a silent no-op."""
    root, _ = cli_runs
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    cfg = sweep_config(tmp_path / "random.csv", encoder_configs())
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main([str(tmp_path / "cfg.yaml"), "--device", "cpu"]) == 0
    _, random_rows = _read_csv(tmp_path / "random.csv")
    _, loaded_rows = _read_csv(root / "port.csv")
    for name in FAMILIES:
        assert any(r["robustness"] != w["robustness"]
                   for r, w in zip(random_rows, loaded_rows)
                   if r["encoder"] == name), name


def test_a_three_channel_resnet_stem_warns_in_both_clis(cli_runs, tmp_path,
                                                       monkeypatch, capsys):
    """A ResNet checkpoint with a 3-channel stem on 1-channel probes: both
    packages size the stem for the probes, fail to graft the checkpoint's
    and say so."""
    from medsegpretrainimagenet_tpu_torch.models.resnet import DeepResNet

    root, _ = cli_runs
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    enc = encoder_configs()[1]
    kwargs = enc["model"]["classification.models.DeepResNet"]
    path = tmp_path / "rgb_stem.pt"
    save_params_file(str(path), reference_state(
        DeepResNet(in_channels=3, **kwargs).state_dict(), "resnet"))
    enc["weights"] = str(path)
    for which, run in (("jax", jax_main), ("port", main)):
        cfg = sweep_config(tmp_path / f"{which}.csv", [enc])
        (tmp_path / f"{which}.yaml").write_text(yaml.safe_dump(cfg))
        argv = [str(tmp_path / f"{which}.yaml")] + (
            ["--device", "cpu"] if which == "port" else [])
        assert run(argv) == 0
        out = capsys.readouterr().out
        assert "1 params of the encoder not in" in out and "left random" \
            in out, (which, out)
        assert "stem_conv" in out, (which, out)


def test_odd_probe_count_warns(cli_runs, tmp_path, monkeypatch, capsys):
    root, _ = cli_runs
    monkeypatch.setenv("MST_DATA_DIR", str(root / "data"))
    cfg = sweep_config(tmp_path / "odd.csv", encoder_configs()[:1], n=7)
    cfg.update(metrics=["l2"], margins=[0.5], levels=[1], pooled=[True])
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    assert main([str(tmp_path / "cfg.yaml"), "--device", "cpu"]) == 0
    assert "odd probe_images (7)" in capsys.readouterr().out
    assert len(_read_csv(tmp_path / "odd.csv")[1]) == 1


def test_cli_prints_its_usage_without_a_config(capsys):
    assert main([]) == 1
    assert "robustness cfg.yaml" in capsys.readouterr().out
