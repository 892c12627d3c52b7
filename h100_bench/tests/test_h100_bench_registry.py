"""BENCHMARK.json against the contract, and every file the harness finds by name."""
import importlib
import json
import re

import pytest

from h100_bench import core, run

BENCH = run.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"][:3] == ["python3", "-m", "h100_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(item["why"]) <= 200 and "\n" not in item["why"] and "\t" not in item["why"]


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"volumes_per_s", "volumes_per_s.dpm10", "request_p95_ms",
                        "train_samples_per_s", "setup_s"}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m for m in e2e.values() if run.applies(m, cell)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert run.applies(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(run.applies(m, cell) for m in BENCH["per_layer"]), cell


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    entry = run.cell_entry(BENCH, cell)
    assert entry["chips"] == 1
    cfg = core.load_json("configs", entry["config"] + ".json")
    wl = core.load_json("workloads", entry["traffic"] + ".json")
    limits = core.load_json("limits", cell + ".json")
    assert cfg["name"] == entry["config"] and limits
    mod = importlib.import_module(f"h100_bench.entries.{wl['entry']}")
    assert callable(mod.run) and callable(mod.calibration)
    assert set(wl) <= mod.KEYS, sorted(set(wl) - mod.KEYS)   # nothing set that nothing reads
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"h100_bench/configs/{entry['config']}.json"
    assert conf["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    read = run.reader(metric)
    assert read({}) is None      # nothing to read: nothing returned


def test_a_traffic_key_that_no_entry_reads_is_refused():
    from h100_bench.entries import sampler

    wl = core.load_json("workloads", "ddim50-b16.json")
    core.check_keys(wl, sampler.KEYS)
    with pytest.raises(ValueError, match="eta"):
        core.check_keys({**wl, "eta": 0.5}, sampler.KEYS)
