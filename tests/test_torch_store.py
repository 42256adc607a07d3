"""The torch port's result store (``repro_torch.store``) against the JAX
package's ``repro.store``, over one ``history.jsonl`` written by port
runs on the CPU (a measured run, a ``--since`` replay and a ``ci``
run): ``store index``, ``query`` and ``store ingest`` give the
reference's rows on the same file, and the port's ``load_history``
through the index gives the records of its scan."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.store import cli as ref_cli
from repro.store import index as ref_index
from repro.store import query as ref_query
from repro.store.ingest import ingest_shards as ref_ingest
from repro_torch.core import history as hist
from repro_torch.store import cli as port_cli
from repro_torch.store import index as port_index
from repro_torch.store import query as port_query
from repro_torch.store.ingest import ingest_shards as port_ingest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPES = ["--enable-scope", "example", "--enable-scope", "instr"]


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def port_cli_run(*args, ok=(0,)):
    r = subprocess.run([sys.executable, "-m", "repro_torch", *args],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=300)
    assert r.returncode in ok, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def history(tmp_path_factory):
    """A history.jsonl of three port runs: measured, replayed, ci."""
    d = str(tmp_path_factory.mktemp("results"))
    common = ["--device", "cpu", *SCOPES, "--results-dir", d,
              "--benchmark_min_time", "0.002"]
    port_cli_run("run", *common, "--run-id", "a", "--benchmark_out",
                 os.devnull)
    port_cli_run("run", *common, "--run-id", "b", "--since",
                 "--benchmark_out", os.devnull)
    # the gate judges host timings of microsecond bodies: either verdict
    # leaves the ci-tagged records this history needs
    port_cli_run("ci", *common, "--run-id", "c", "--full", "--no-report",
                 ok=(0, 1))
    return hist.history_path(d)


@pytest.fixture
def stores(history, tmp_path):
    """The history copied twice, indexed by each package."""
    out = {}
    for package, index in (("port", port_index), ("ref", ref_index)):
        path = tmp_path / package / "history.jsonl"
        path.parent.mkdir()
        shutil.copy(history, path)
        index.refresh(str(path))
        out[package] = str(path)
    return out


def test_history_carries_fingerprints_and_cached(history):
    records = hist.scan_history(history)
    assert {r["run_id"] for r in records} == {"a", "b", "c"}
    assert all(len(r["fingerprint"]) == 16 for r in records)
    assert all(r.get("cached") for r in records if r["run_id"] == "b")
    assert all(r.get("tag") == "ci" for r in records if r["run_id"] == "c")


FILTERS = [
    {},
    {"scope": "instr"},
    {"family": "example/axpy"},
    {"params": {"op": ["gelu", "exp"]}},
    {"run_id": "b"},
    {"tag": "ci"},
    {"tag": ""},
    {"since": "2000-01-01", "until": "2999-01-01"},
]


@pytest.mark.parametrize("flt", FILTERS)
def test_query_rows_equal_reference(stores, flt):
    port = list(port_query.run_query(stores["port"],
                                     port_query.QueryFilter(**flt)))
    ref = list(ref_query.run_query(stores["ref"],
                                   ref_query.QueryFilter(**flt)))
    assert port == ref and (port or flt.get("tag") == "")
    scan = list(port_query.run_query(stores["port"],
                                     port_query.QueryFilter(**flt),
                                     use_store="never"))
    assert port == scan


def test_query_by_fingerprint_equals_reference(stores):
    fingerprint = hist.scan_history(stores["port"])[0]["fingerprint"]
    flt = {"fingerprint": fingerprint}
    port = list(port_query.run_query(stores["port"],
                                     port_query.QueryFilter(**flt)))
    assert len(port) == 3
    assert port == list(ref_query.run_query(stores["ref"],
                                            ref_query.QueryFilter(**flt)))


@pytest.mark.parametrize("args", [
    ["--scope", "instr", "--format", "jsonl"],
    ["--family", "example/axpy", "--format", "json"],
    ["--param", "op=gelu"],
    ["--scope", "example", "--aggregate", "--percentiles", "p50,p99",
     "--format", "json"],
    ["--tag", "ci", "--aggregate"],
])
def test_query_cli_output_equals_reference(stores, capsys, args):
    assert port_cli.query_main(["--history", stores["port"], *args]) == 0
    port = capsys.readouterr().out
    assert ref_cli.query_main(["--history", stores["ref"], *args]) == 0
    assert port == capsys.readouterr().out and port


def test_store_status_equals_reference(stores):
    port = port_index.store_status(stores["port"])
    ref = ref_index.store_status(stores["ref"])
    for info in (port, ref):
        info.pop("history"), info.pop("db")
    assert port == ref and port["records"] == 51
    assert port["fingerprints"] == 17


def test_store_cli_index_builds_the_db(history, tmp_path, capsys):
    path = tmp_path / "history.jsonl"
    shutil.copy(history, path)
    assert port_cli.store_main(["index", "--history", str(path)]) == 0
    assert os.path.exists(port_index.db_path(str(path)))
    assert "+51 record(s), 51 total" in capsys.readouterr().out
    assert port_cli.store_main(["index", "--history",
                                str(tmp_path / "none.jsonl")]) == 1


def test_load_history_through_the_index_equals_scan(stores):
    path = stores["port"]
    records = hist._store_records(path)
    assert records is not None
    assert records == hist.scan_history(path) == hist.load_history(path)
    assert hist.load_history(path, store=False) == records


def test_ingest_equals_reference(history, tmp_path):
    """Two machines' shards merged into an empty store: the same history
    bytes and summary as the reference's, whole runs deduplicated."""
    with open(history) as f:
        lines = f.readlines()
    shard_a = tmp_path / "lab-a.jsonl"
    shard_b = tmp_path / "lab-b.jsonl"
    shard_a.write_text("".join(l for l in lines if '"run_id": "a"' in l))
    shard_b.write_text("".join(lines))
    out = {}
    for package, ingest in (("port", port_ingest), ("ref", ref_ingest)):
        d = tmp_path / package
        d.mkdir()
        stats = ingest(str(d), [str(shard_a), str(shard_b)])
        with open(d / "history.jsonl") as f:
            out[package] = (stats.summary(), f.read())
    assert out["port"] == out["ref"]
    assert out["port"][1] == "".join(lines)


def test_store_status_coverage_counts_fresh_instances(history):
    r = port_cli_run("store", "status", "--history", history, "--coverage",
                     "--device", "cpu", "--format", "json")
    cov = json.loads(r.stdout)["coverage"]
    assert cov["scopes"]["example"] == {"fresh": 8, "stale": 0, "never": 0}
    assert cov["scopes"]["instr"] == {"fresh": 9, "stale": 0, "never": 0}
    assert cov["scopes"]["comm"]["never"] == 27
