"""BENCHMARK.json keeps to the benchmark's format rules, a cell is found by
its name alone, and a run without a card fails."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import core, drive

from .helpers import TINY, native

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_rules():
    text = (REPO / "BENCHMARK.json").read_text()
    spec = json.loads(text)
    assert len(text.encode()) <= 64 << 10
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["gpubench"] and spec["command"][:1] == ["python3"]
    cells = {w["name"]: w for w in spec["workloads"]}
    names = [c["name"] for c in spec["configs"]] + list(cells) + [
        m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert core.read_json("configs", c["name"])["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in cells.values())
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (core.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = {m["name"] for m in core.metrics_for(spec, w["name"],
                                                        "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = core.metrics_for(spec, w["name"], "per_layer")
        assert layer and all(m["moves"] in reported for m in layer)
        core.find_cell(spec, w["name"])
    n = len(cells)
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert n <= 24 and 1 <= spec["run_seconds"] <= 51


def test_a_new_cell_is_found_by_its_name(tmp_path):
    """A cell, a configuration, a traffic mix, a loop and a metric added
    as new files and new entries, with no file that is there edited."""
    shutil.copytree(core.BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = tmp_path / "gpubench"
    (bench / "configs" / "text-small.json").write_text(json.dumps({
        "name": "text-small", "source": "a test", "generator":
        "text_standin", "generator_args": {"n_bytes": 300_000}, "level": 1,
        "ext": False}))
    (bench / "loops" / "three_calls.py").write_text(
        "def run(call, seconds, loop, record):\n"
        "    for k in range(3):\n"
        "        record(k, k + 1, call(), None)\n"
        "    return 3.0\n")
    mix = json.loads((bench / "traffic" / "decode.json").read_text())
    mix["loop"] = {"kind": "three_calls"}
    mix["input"][0]["args"]["level"] = 0
    (bench / "traffic" / "decode-three.json").write_text(json.dumps(mix))
    (bench / "cells" / "text-small.decode-three.json").write_text(
        json.dumps({"config": "text-small", "traffic": "decode-three"}))
    (bench / "metrics" / "calls_per_s.decode.py").write_text(
        "def read(run):\n    return run.user_bytes / 300_000 / run.window_s\n")
    spec["configs"].append({"name": "text-small", "source": "a test",
                            "file": "gpubench/configs/text-small.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "text-small.decode-three",
                              "config": "text-small", "traffic":
                              "decode-three", "chips": 1, "why": "a test"})
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    e2e["decode_MBps"]["workloads"].append("text-small.decode-three")
    spec["per_layer"].append({"name": "calls_per_s.decode", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "entry", "moves": "decode_MBps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    r = core.run_cell("text-small.decode-three", 5, 0.5, False,
                      root=tmp_path, bench_dir=bench, on_card=False,
                      wrap=native)
    assert r["correct"] and r["attempted"] == 3
    assert set(r["metrics"]) == {"decode_MBps", "host_cpu_s_per_GB",
                                 "setup_s"}
    assert r["metrics"]["decode_MBps"]["value"] == 3 * 300_000 / 3.0 / 1e6
    layer = core.metrics_for(core.load_spec(tmp_path),
                             "text-small.decode-three", "per_layer")
    assert [m["name"] for m in layer] == ["calls_per_s.decode"]
    assert core.load_reader("calls_per_s.decode", bench)
    # the cells that were there are found as before
    assert set(TINY) <= {w["name"] for w in spec["workloads"]}
    for cell in TINY:
        assert core.find_cell(core.load_spec(tmp_path), cell, bench)


def test_the_mix_is_read_whole():
    """Every key of a mix is read: a second caller runs, and a key that
    nothing reads is refused."""
    cell = "tsqb-text-l0.compress"
    mix = core.read_json("traffic", "compress")
    r = core.run_cell(cell, 8, 0.3, False, on_card=False, wrap=native,
                      overrides={**TINY[cell], "traffic": {
                          "loop": {"kind": "closed", "callers": 2}}})
    assert r["correct"] and r["attempted"] >= 2
    for bad in ({**mix, "arrivals": "poisson"},
                {k: v for k, v in mix.items() if k != "counts"}):
        with pytest.raises(ValueError):
            drive.Traffic(bad, core.read_json("configs", "tsqb-text-l0"),
                          b"x", 1)
    with pytest.raises(ValueError):
        core.run_cell(cell, 8, 0.3, False, on_card=False, wrap=native,
                      overrides={**TINY[cell], "traffic": {
                          "loop": {"kind": "closed", "callers": 2,
                                   "rate": 3}}})


def test_a_run_without_a_card_fails():
    r = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                        "tsqb-text-l0.decode", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr
