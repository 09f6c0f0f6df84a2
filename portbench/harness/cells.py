"""Finds a cell's pieces by name.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``, under
``portbench/configs/``) and a traffic mix (``portbench/traffic/<mix>.json``,
which names the entry of the program that its window drives,
``portbench/entries/<entry>.py``); its limits are
``portbench/limits/<cell>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Adding a cell takes new files and new
entries in ``BENCHMARK.json``, no edit.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1

    @property
    def model(self) -> dict:
        return self.config["model"]


def find_cell(name: str, bench: dict | None = None,
              root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, limits and metrics; raises KeyError for an unknown name."""
    bench = bench if bench is not None else benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     f"{work['traffic']}.json"))
    limits = load_json(os.path.join(root, "portbench", "limits",
                                    f"{name}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, work, config, traffic, limits, e2e, per_layer,
                work.get("chips", 1))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(traffic: dict, root: str = ROOT):
    """The module that drives the traffic's entry of the program."""
    return load_module(os.path.join(root, "portbench", "entries",
                                    f"{traffic['entry']}.py"),
                       f"portbench_entry_{traffic['entry']}")


def reader(metric: str, root: str = ROOT) -> Callable[[dict], object]:
    """``read(data) -> number or None`` of one per-layer metric."""
    mod = load_module(os.path.join(root, "portbench", "metrics",
                                   f"{metric}.py"),
                      "portbench_metric_" + metric.replace(".", "_"))
    return mod.read


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's ``--seed``: the same seed and
    tags give the same value, any whole number is taken."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "big") >> 1
