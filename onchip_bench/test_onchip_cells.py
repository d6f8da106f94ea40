"""Every cell of BENCHMARK.json resolves its files by name, and the file
keeps to the benchmark's contract as far as it can be read without a run.

    python -m pytest -q onchip_bench
"""
import json
import re

import pytest

import harness

BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


WITHHELD = harness.load_json(harness.BENCH_DIR / "withheld.json")


@pytest.mark.parametrize("workload", [
    w["name"] for w in BENCH["workloads"] + WITHHELD["workloads"]])
def test_cell_resolves_its_files_by_name(workload):
    cell = harness.resolve(workload, withheld=True)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.readers[m["name"]].read)
    for part in ("make_input", "make_space", "make_args", "work"):
        assert callable(getattr(cell.kernel, part))
    assert callable(cell.reference.reference)
    assert callable(cell.reference.control)
    assert set(cell.checks) == set(cell.config["check"]) == {
        "failed_episodes", "best_untested", "best_outside", "kernel_rel_err"}
    assert all(callable(c.read) for c in cell.checks.values())
    # the session's and the window's numbers are exact comparisons
    assert all(cell.config["check"][n] == 0 for n in
               ("failed_episodes", "best_untested", "best_outside"))
    assert callable(cell.driver.window) and callable(cell.driver.warm_up)
    assert cell.traffic["searcher"] and int(cell.traffic["seed_pool"]) > 0


def test_withheld_cells_are_not_in_the_benchmark():
    assert not ({w["name"] for w in WITHHELD["workloads"]}
                & {w["name"] for w in BENCH["workloads"]})
    merged = harness.with_withheld(BENCH)
    assert len(merged["workloads"]) == (len(BENCH["workloads"])
                                        + len(WITHHELD["workloads"]))
    with pytest.raises(KeyError):
        harness.resolve(WITHHELD["workloads"][0]["name"])


def test_benchmark_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["onchip_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24
    # a full check with 24 cells fits into its 43200 seconds
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("onchip_bench/")
        assert harness.load_json(harness.CHECKOUT / c["file"])["name"] == \
            c["name"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    named = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(named) == len(set(named))
    assert all(NAME.match(n) for n in named)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
