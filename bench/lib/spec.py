"""What a cell is made of, read from files by name.

``BENCHMARK.json`` at the checkout's root lists the cells; a cell names
a configuration (``bench/configs/<config>.json``, found through the
``configs`` entry's ``file``) and a traffic mix
(``bench/traffic/<traffic>.json``); its limits for ``correct`` are
``bench/limits/<cell>.json``; each metric is read by
``bench/metrics/<metric>.py``; each configuration's ``reference`` names
its plain reference, ``bench/reference/<reference>.py``.  Adding a cell
adds files and entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = read_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=read_json(root / conf["file"]),
                traffic=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(BENCH / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reference(config: Dict[str, Any]):
    """The configuration's plain reference module."""
    return importlib.import_module(f"bench.reference.{config['reference']}")


def reader(metric: str):
    """``bench/metrics/<metric>.py``'s ``read(record)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks(device_name: str) -> Dict[str, float]:
    """The data-sheet peaks of a card by the name torch reports; a card
    that the table does not list is refused."""
    table = read_json(BENCH / "lib" / "peaks.json")
    if device_name not in table:
        raise KeyError(f"no peaks for {device_name!r}: the benchmark lists "
                       f"{sorted(k for k in table if not k.startswith('_'))}")
    return table[device_name]


def model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file: its
    ``model`` (the published sizes) and ``policy`` (the knobs it is run
    with)."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name=config["name"], **config["model"],
                       **config["policy"])
