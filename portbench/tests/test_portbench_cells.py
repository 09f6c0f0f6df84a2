"""BENCHMARK.json and the files it names: every cell's configuration,
traffic, limits and readers load by name, and a cell made of new files
alone runs."""

import json
import os
import re
import shutil

import pytest

from portbench.harness import cells
from conftest import ROOT, context

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell = cells.find_cell(w, bench)
            assert m["moves"] in [e["name"] for e in cell.end_to_end]
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", ["iq_big.serve_stream_b256",
                                  "iq_big.train_b512",
                                  "iq_big_vit.serve_stream_b256"])
def test_cells_load_by_name(bench, name):
    cell = cells.find_cell(name, bench)
    conf = {c["name"]: c for c in bench["configs"]}[cell.workload["config"]]
    assert cell.config["name"] == conf["name"]
    assert sorted(cell.config["reduced"]) == sorted(conf["reduced"])
    assert len(cell.config["source"]) <= 200
    assert os.path.exists(os.path.join(ROOT, "portbench", "entries",
                                       f"{cell.traffic['entry']}.py"))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert callable(cells.entry(cell.traffic).run)


def test_every_config_has_a_cell(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_sub_seed_takes_large_seeds():
    big = 2 ** 31 + 17
    assert cells.sub_seed(big, "x") == cells.sub_seed(big, "x")
    assert cells.sub_seed(big, "x") != cells.sub_seed(big + 1, "x")
    assert 0 <= cells.sub_seed(2 ** 40, "weights") < 2 ** 63


def test_a_cell_from_new_files_alone(tmp_path, bench):
    """A dummy configuration, traffic mix, limits file and per-layer
    reader, plus new entries in BENCHMARK.json, make a cell that loads and
    runs (on the CPU, at a tiny size) with no file of the benchmark
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    conf = json.load(open(os.path.join(ROOT,
                                       "portbench/configs/iq_big.json")))
    conf["name"] = "iq_dummy"
    conf["model"].update(emb_dim=16, hidden_dim=32, latent_dim=24,
                         pwffn_dim=64, num_layers=1, num_heads=4,
                         image_size=32, max_decode_length=6, dtype="float32")
    conf["vocab_size"] = 40
    (root / "portbench/configs/iq_dummy.json").write_text(json.dumps(conf))
    traffic = json.load(open(os.path.join(
        ROOT, "portbench/traffic/serve_stream_b256.json")))
    traffic.update(batch=2, pool=4, warmup_batches=1, profile_batches=1)
    (root / "portbench/traffic/dummy_b2.json").write_text(json.dumps(traffic))
    (root / "portbench/limits/iq_dummy.dummy_b2.json").write_text(
        json.dumps({"widest_gap": 1e-3}))
    (root / "portbench/metrics/dummy_batches.py").write_text(
        "def read(data):\n    return data.get('batches')\n")
    new["configs"].append({"name": "iq_dummy", "source": "a test",
                           "file": "portbench/configs/iq_dummy.json",
                           "reduced": [], "why": "test"})
    new["workloads"].append({"name": "iq_dummy.dummy_b2",
                             "config": "iq_dummy", "traffic": "dummy_b2",
                             "chips": 1, "why": "test"})
    for m in new["end_to_end"]:
        if "decode_questions_per_s" == m["name"]:
            m["workloads"].append("iq_dummy.dummy_b2")
    new["per_layer"].append({"name": "dummy_batches", "unit": "batches",
                             "better": "higher", "source": "host_clock",
                             "layer": "test", "moves":
                             "decode_questions_per_s",
                             "workloads": ["iq_dummy.dummy_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    cell = cells.find_cell("iq_dummy.dummy_b2", root=str(root))
    assert [m["name"] for m in cell.per_layer] == ["dummy_batches"]
    assert [m["name"] for m in cell.end_to_end] == ["decode_questions_per_s",
                                                    "setup_s"]
    res = cells.entry(cell.traffic, root=str(root)).run(
        context(cell, trace=True))
    assert res["checks"]["widest_gap"][0] <= 1e-3
    read = cells.reader("dummy_batches", root=str(root))
    assert read(res["data"]) == res["units"] >= 2
