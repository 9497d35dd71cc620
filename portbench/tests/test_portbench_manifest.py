"""BENCHMARK.json against the format's rules on names, units and files,
and the harness finding every file by name."""
from __future__ import annotations

import json
import os
import re

import pytest

from portbench import run as runmod

ROOT = runmod.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    names += [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [w[k] for w in manifest["workloads"] for k in ("config", "traffic")]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)


def test_bounds_and_sources(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert w in moved.get("workloads", [w])


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_named_file_exists(manifest, kind):
    for entry in manifest[kind]:
        if kind == "configs":
            assert os.path.exists(os.path.join(ROOT, entry["file"]))
            assert entry["file"].startswith("portbench/configs/")
        else:
            cell, config = runmod.cell_files(entry["name"])
            assert cell["config"] == entry["config"] and config["name"] == entry["config"]
            assert cell["chips"] == entry["chips"]
            assert os.path.exists(os.path.join(runmod.HERE, "drivers", cell["driver"] + ".py"))


def test_every_cell_reports_setup_another_e2e_and_a_layer(manifest):
    for w in manifest["workloads"]:
        e2e, layers = runmod.manifest_metrics(manifest, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layers


def test_every_metric_has_a_reader(manifest):
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(runmod.HERE, "metrics", m["name"] + ".py")), m["name"]


def test_configs_are_used_and_reduced_is_listed(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
