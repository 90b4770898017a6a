"""BENCHMARK.json against the contract's shapes, and each of its names
against the files the harness finds by that name."""
import json
import re

import pytest

from portbench import core

B = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert len(json.dumps(B)) <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51
    assert all(_line(w) for w in B["command"]) and len(B["command"]) <= 32
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in B["configs"]]
    names += [w["name"] for w in B["workloads"]]
    names += [w["config"] for w in B["workloads"]]
    names += [w["traffic"] for w in B["workloads"]]
    names += [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    names += [k for c in B["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in B["end_to_end"] + B["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in B[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(ms) == len(set(ms))


def test_entry_keys():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    assert [m for m in B["end_to_end"] if m["name"] == "setup_s"]


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_metrics(w):
    cell = core.Cell(w["name"])
    assert cell.entry().setup
    assert [m for m in cell.end_to_end if m["name"] == "setup_s"]
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in e2e, m["name"]
    cfg = [c for c in B["configs"] if c["name"] == w["config"]][0]
    data = core.load_json(core.ROOT / cfg["file"])
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert set(cfg["reduced"]) <= set(data["upstream"])


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader_that_declares_it(m):
    mod = core.load_metric(m["name"])
    assert (mod.SOURCE, mod.LAYER, mod.MOVES) == (m["source"], m["layer"],
                                                  m["moves"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in B["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
