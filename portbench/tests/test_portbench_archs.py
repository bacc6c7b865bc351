"""An architecture is a file of its own: the two the benchmark runs read
as they did before each had a module (``portbench/archs/``), and a fourth
one joins a copy of the benchmark by new files alone and goes through the
harness's reference, FLOP count and ``stats`` check."""
import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import session, spec, traffic, weights
from portbench.control import leaves_of
from portbench.reference.train import train_reference
from portbench.tests.cells import small_cell

BENCH = spec.load_benchmark()
ARCH_FUNCTIONS = ("shape_of", "forward", "drop_rates", "attention_calls",
                  "small")

#: ``train_reference`` of the small cells (seed 2**33 + 17, one CPU
#: thread) before the architectures had modules of their own: the losses
#: and the norms of the BatchNorm statistics' change, by name
PINNED = {
    "swin_unet_224.train_b256": {
        "loss": [0.46540552377700806,
                 0.4989619851112366,
                 0.4807593822479248],
        "stats": {}},
    "unet_256.train_b32": {
        "loss": [0.47478294372558594,
                 0.496135413646698,
                 0.4887496829032898],
        "stats": {
            "enc.level_convs.0.0.BatchNorm_0.running_mean":
                0.15306124091148376,
            "enc.level_convs.0.0.BatchNorm_0.running_var":
                0.7131136059761047,
            "enc.level_convs.0.0.BatchNorm_1.running_mean":
                0.34412550926208496,
            "enc.level_convs.0.0.BatchNorm_1.running_var":
                0.29701006412506104,
            "enc.level_convs.1.0.BatchNorm_0.running_mean":
                1.3688644170761108,
            "enc.level_convs.1.0.BatchNorm_0.running_var":
                0.47573915123939514,
            "enc.level_convs.1.0.BatchNorm_1.running_mean":
                0.6671239733695984,
            "enc.level_convs.1.0.BatchNorm_1.running_var":
                0.37525880336761475,
            "enc.bottom_convs.0.BatchNorm_0.running_mean":
                1.8769991397857666,
            "enc.bottom_convs.0.BatchNorm_0.running_var":
                0.8096177577972412,
            "enc.bottom_convs.0.BatchNorm_1.running_mean":
                0.8112874031066895,
            "enc.bottom_convs.0.BatchNorm_1.running_var":
                0.6174196004867554,
            "dec.level_convs.0.0.BatchNorm_0.running_mean":
                0.5007253885269165,
            "dec.level_convs.0.0.BatchNorm_0.running_var":
                0.41948747634887695,
            "dec.level_convs.0.0.BatchNorm_1.running_mean":
                0.5684937834739685,
            "dec.level_convs.0.0.BatchNorm_1.running_var":
                0.4224545955657959,
            "dec.level_convs.1.0.BatchNorm_0.running_mean":
                0.5774747729301453,
            "dec.level_convs.1.0.BatchNorm_0.running_var":
                0.3229871988296509,
            "dec.level_convs.1.0.BatchNorm_1.running_mean":
                0.44844678044319153,
            "dec.level_convs.1.0.BatchNorm_1.running_var":
                0.2283387929201126,
        }},
}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_names_its_architecture(config):
    data = json.loads((spec.ROOT / config["file"]).read_text())
    arch = spec.load_arch(data)
    for name in ARCH_FUNCTIONS:
        assert callable(getattr(arch, name)), name


@pytest.mark.parametrize("name", sorted(PINNED))
def test_reference_reads_as_before(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = small_cell(name)
        cpu = torch.device("cpu")
        seed = 2 ** 33 + 17
        w = weights.make_weights(leaves_of(cell, cpu), cell.config["weights"],
                                 seed, cpu)
        pool = traffic.make_pool(cell.traffic, 32, 3, seed, cpu)
        lr, momentum = session._lr_momentum(cell.config["tree"])
        ref = train_reference(spec.load_arch(cell.config),
                              cell.config["tree"], w, pool[:3], seed, lr,
                              momentum)
    finally:
        torch.set_num_threads(threads)
    pinned = PINNED[name]
    assert ref["loss"] == pytest.approx(pinned["loss"], rel=1e-7)
    assert set(ref["stats"]) == set(pinned["stats"])
    for key, value in pinned["stats"].items():
        assert ref["stats"][key] == pytest.approx(value, rel=1e-7), key


# ---------------------------------------------------------------------------
# a fourth architecture, by new files alone
# ---------------------------------------------------------------------------

TOY = textwrap.dedent("""
    \"\"\"A toy architecture: a strided conv, a grouped and dilated conv,
    two BatchNorms, a skip and a sigmoid output.\"\"\"
    import copy

    import torch
    import torch.nn.functional as F

    from portbench.reference.ops import Ops


    def shape_of(tree):
        return tree["model"]["toy"]["channels"]


    def drop_rates(shape):
        return []


    def attention_calls(shape, batch):
        return []


    def small(tree):
        return copy.deepcopy(tree)


    def _bn(ops, p, running, name, x, train):
        return ops.batch_norm(name, x, p[f"{name}.weight"],
                              p[f"{name}.bias"],
                              running[f"{name}.running_mean"],
                              running[f"{name}.running_var"], train)


    def forward(ops, p, x, shape, train, keeps=None, running=None,
                ckpt=False):
        running = running if running is not None else p
        h = ops.conv(x, p["stem.conv.weight"], p["stem.conv.bias"],
                     stride=2, pads=((1, 1), (1, 1)), first=True)
        skip = torch.relu(_bn(ops, p, running, "stem.bn", h, train))
        h = ops.conv(skip, p["mid.conv.weight"], pads=((2, 2), (2, 2)),
                     groups=4, dilation=2)
        h = torch.relu(_bn(ops, p, running, "mid.bn", h, train)) + skip
        h = ops.conv(h, p["head.conv.weight"], p["head.conv.bias"])
        h = F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                          mode="nearest").permute(0, 2, 3, 1)
        return ops.output(torch.sigmoid(h))
""")

TOY_LEAVES = {"stem.conv.weight": (8, 3, 3, 3), "stem.conv.bias": (8,),
              "mid.conv.weight": (8, 2, 3, 3), "head.conv.weight": (1, 8, 1, 1),
              "head.conv.bias": (1,)}
for _bn in ("stem.bn", "mid.bn"):
    TOY_LEAVES.update({f"{_bn}.{k}": (8,) for k in
                       ("weight", "bias", "running_mean", "running_var")})

#: stem 8 x 8 outputs of 8 channels, 3 x 9 weights each; the grouped conv
#: 8 x 8 x 8 of 2 x 9; the head 8 x 8 of 8
TOY_MACS = (8 * 8 * 8 * 27 + 8 * 8 * 8 * 18 + 8 * 8 * 8, 8 * 8 * 8 * 27)

DRIVE = textwrap.dedent("""
    import json, sys
    import torch
    import portbench
    from portbench import check, flops, spec, traffic, weights
    from portbench.reference.train import eval_reference, train_reference

    leaves = {leaves!r}
    cell = spec.load_cell("toy_16.train_b4")
    arch = spec.load_arch(cell.config)
    tree = arch.small(cell.config["tree"])
    cpu = torch.device("cpu")
    w = weights.make_weights([(n, s, torch.float32) for n, s in
                              leaves.items()], cell.config["weights"], 7, cpu)
    pool = traffic.make_pool(cell.traffic, 16, 3, 7, cpu)
    ref = train_reference(arch, tree, w, pool[:3], 7, 1e-3, 0.9)
    low = train_reference(arch, tree, w, pool[:3], 7, 1e-3, 0.9, "fp8")
    out = eval_reference(arch, tree, w, pool[0])
    print(json.dumps({{
        "file": portbench.__file__,
        "stats": ref["stats"],
        "sound": check.train_numbers(ref, ref),
        "control": check.train_numbers(low, ref),
        "macs": flops.forward_macs(arch, tree, 16, 3, leaves),
        "prediction": list(out["prediction"].shape),
        "dice": out["values"]["dice"]}}))
""")


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_architecture_is_files_only(tmp_path):
    shutil.copytree(spec.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    before = _files(tmp_path)
    new = {
        "portbench/archs/toy.py": TOY,
        "portbench/configs/toy_16.json": json.dumps({
            "name": "toy_16", "source": "https://arxiv.org/abs/1505.04597",
            "reference": "toy", "image_size": 16, "in_channels": 3,
            "weights": "kaiming_normal", "reduced": [],
            "tree": {"model": {"toy": {"channels": 8}}}}),
        "portbench/traffic/train_b4.json": json.dumps(dict(
            spec.load_cell("unet_256.train_b32").traffic, batch=4, pool=4)),
        "portbench/workloads/toy_16.train_b4.json": json.dumps({
            "name": "toy_16.train_b4", "config": "toy_16",
            "traffic": "train_b4", "entry": "train_step",
            "compute_dtype": "float32", "metrics": ["metrics.DiceIndex"],
            "chips": 1, "why": "a toy", "limits": {"loss": 0.01}})}
    for path, text in new.items():
        (tmp_path / path).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_16", "source": "a toy",
                             "file": "portbench/configs/toy_16.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy_16.train_b4",
                               "config": "toy_16", "traffic": "train_b4",
                               "chips": 1, "why": "a toy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    proc = subprocess.run(
        [sys.executable, "-c", DRIVE.format(leaves=TOY_LEAVES)],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    # the statistics are paired by the toy's own layer names
    assert set(got["stats"]) == {f"{bn}.{k}" for bn in ("stem.bn", "mid.bn")
                                 for k in ("running_mean", "running_var")}
    assert all(v > 0 for v in got["stats"].values())
    assert got["sound"] == {"loss": 0.0, "grad": 0.0, "change": 0.0,
                            "stats": 0.0}
    assert got["control"]["stats"] > 0
    assert tuple(got["macs"]) == TOY_MACS
    assert got["prediction"] == [4, 16, 16] and 0 <= got["dice"] <= 1

    after = _files(tmp_path)
    changed = {p for p in before if after.get(p) != before[p]}
    assert changed == {"BENCHMARK.json"}
    old = json.loads(before["BENCHMARK.json"])
    for section in ("configs", "workloads"):
        assert bench[section][:len(old[section])] == old[section]
    assert set(after) - set(before) == set(new)
