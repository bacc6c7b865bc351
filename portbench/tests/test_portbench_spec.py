"""The harness finds every cell, configuration, traffic mix, entry and
metric by its name, in a file of its own, and every name and unit keeps to
the characters the benchmark's contract allows."""
import json
import re

import pytest
import torch

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    found = spec.load_cell(cell)
    assert found.workload["config"] == entry["config"]
    assert found.workload["traffic"] == entry["traffic"]
    assert found.chips == entry["chips"] in (1, 4)
    assert found.workload["why"] == entry["why"]
    assert callable(spec.load_module("entries",
                                     found.workload["entry"]).run)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_found_by_name(config):
    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    reader = spec.load_module("metrics", metric["name"])
    assert reader.read(None) is None
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for cell in metric["workloads"]:
        assert cell in CELLS
        moved = next(m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"])
        assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
    if "layer" in metric:
        assert TEXT.match(metric["layer"])


def test_every_name_is_allowed():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in METRICS] + \
        [w["traffic"] for w in BENCH["workloads"]] + \
        [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names)
    for group in (CELLS, [c["name"] for c in BENCH["configs"]],
                  [m["name"] for m in METRICS]):
        assert len(group) == len(set(group))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for text in [w["why"] for w in BENCH["workloads"]] + \
            [c["source"] for c in BENCH["configs"]] + BENCH["command"]:
        assert TEXT.match(text)


def test_every_cell_reports_what_it_must():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.cell_metrics(BENCH, cell,
                                                    "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.cell_metrics(BENCH, cell, "per_layer")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_cells_report_a_peak_share_beside_each_roofline():
    for metric in BENCH["per_layer"]:
        if metric["name"].split(".")[0].endswith("_roofline"):
            assert metric["unit"] == "%"
            assert any("mfu" in m["name"] and m["moves"] == metric["moves"]
                       and set(metric["workloads"]) <= set(m["workloads"])
                       for m in BENCH["per_layer"])


def test_every_file_loads_by_its_name():
    files = {p.stem for p in (spec.BENCH / "workloads").glob("*.json")}
    assert set(CELLS) <= files
    for name in files:
        cell = spec.load_cell(name)
        assert cell.workload["name"] == name and cell.limits
        spec.load_module("entries", cell.workload["entry"])
    readers = {p.stem for p in (spec.BENCH / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= readers


def test_traffic_order_sorts_each_batch_by_mask_area():
    from portbench import traffic
    params = dict(spec.load_cell("unet_256.train_b32").traffic, batch=6,
                  pool=2)
    assert params["order"] == "mask_area"
    cpu = torch.device("cpu")
    ordered = traffic.make_pool(params, 32, 3, 2 ** 40 + 5, cpu)
    params.pop("order")
    plain = traffic.make_pool(params, 32, 3, 2 ** 40 + 5, cpu)
    for a, b in zip(ordered, plain):
        area = a["mask"].view(6, -1).sum(-1)
        assert torch.equal(area, area.sort().values)
        assert sorted(map(bytes, a["x"].numpy())) \
            == sorted(map(bytes, b["x"].numpy()))
