"""BENCHMARK.json and the files its names point to."""
import json
import re

import pytest

from snsbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    b = spec.bench()
    for w in b["workloads"]:
        cfg = spec.config(w["config"], b)
        assert cfg["name"] == w["config"]
        traffic = spec.traffic(w["traffic"])
        assert spec.driver(traffic["driver"]).CHIPS == w["chips"]
        stage = spec.stages(cfg["check"]["stages"])
        assert set(stage.NUMBERS) <= set(cfg["check"]["limits"])
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(w["name"], kind, b):
                assert callable(spec.reader(m["name"]))


def test_names_units_and_keys_keep_to_the_contract():
    b = spec.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert all(m["moves"] in e2e for m in b["per_layer"])


def test_a_config_file_states_what_the_check_and_the_program_need():
    b = spec.bench()
    for c in b["configs"]:
        cfg = spec.config(c["name"], b)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert {"data", "sns", "check"} <= set(cfg)
        assert cfg["sns"]["embedder"] in cfg


def test_a_metric_without_a_reading_is_left_out():
    ctx = {"maps": [{"stages": {}, "launches": {}, "dataset": 0}],
           "profiled": None}
    out = spec.read_metrics([{"name": "k7_roofline", "unit": "%"},
                             {"name": "embed_s", "unit": "s"}], ctx)
    assert out == {}


@pytest.mark.parametrize("name", ["sketch_s", "replicas_s", "embed_s"])
def test_stage_means_leave_the_profiled_map_out(name):
    stage = name[:-2]
    ctx = {"maps": [{"stages": {stage: 9.0}}, {"stages": {stage: 1.0}},
                    {"stages": {stage: 3.0}}], "profiled": 0}
    assert spec.reader(name)(ctx) == 2.0


def test_the_benchmark_file_is_valid_json_under_64_kib():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) < 64 * 1024
    json.loads(raw)
