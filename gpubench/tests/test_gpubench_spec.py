"""BENCHMARK.json keeps to the benchmark's format rules, a cell is found by
its name alone, a run sees exactly its cell's cards, and a run without a
card fails."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from gpubench import core, drive

from .helpers import TINY, native

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_rules():
    text = (REPO / "BENCHMARK.json").read_text()
    _keeps_to_the_rules(json.loads(text), text, core.BENCH_DIR)


def _keeps_to_the_rules(spec, text, bench_dir):
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
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        reported = {m["name"] for m in core.metrics_for(spec, w["name"],
                                                        "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        layer = core.metrics_for(spec, w["name"], "per_layer")
        assert layer and all(m["moves"] in reported for m in layer)
        core.find_cell(spec, w["name"], bench_dir)
    n = len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, n // 4)
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert n <= 24 and 1 <= spec["run_seconds"] <= 51


def _with_cells(tmp_path, chips):
    """BENCHMARK.json, its text and a copy of the harness, with one more
    decode cell of ``chips`` cards for each entry of ``chips``, each with
    a traffic mix of its own, and the decode's metrics listing it."""
    bench = tmp_path / "gpubench"
    shutil.copytree(core.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    mix = (bench / "traffic" / "decode.json").read_text()
    metrics = spec["end_to_end"] + spec["per_layer"]
    for k, n in enumerate(chips):
        name = f"tsqb-text-l0.decode-{k}"
        (bench / "traffic" / f"decode-{k}.json").write_text(mix)
        (bench / "cells" / f"{name}.json").write_text(json.dumps(
            {"config": "tsqb-text-l0", "traffic": f"decode-{k}"}))
        spec["workloads"].append({"name": name, "config": "tsqb-text-l0",
                                  "traffic": f"decode-{k}", "chips": n,
                                  "why": "a test"})
        for m in metrics:
            if "tsqb-text-l0.decode" in m.get("workloads", []):
                m["workloads"].append(name)
    return spec, json.dumps(spec), bench


@pytest.mark.parametrize("chips, keeps", [
    ((1, 4), True),        # one four-card cell of four
    ((4,), True),          # one four-card cell is always allowed
    ((1, 4, 4), False),    # two of five: 25 % rounded down is one
    ((1, 1, 1, 1, 1, 1, 4, 4), True),   # two of ten
    ((2,), False),         # one card or four, nothing else
    ((1, 8), False),
])
def test_the_rules_admit_four_card_cells_within_the_limit(tmp_path, chips,
                                                         keeps):
    spec, text, bench = _with_cells(tmp_path, chips)
    if keeps:
        _keeps_to_the_rules(spec, text, bench)
    else:
        with pytest.raises(AssertionError):
            _keeps_to_the_rules(spec, text, bench)


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
    # a four-card cell: its mix spreads the blocks over four devices
    mix["args"] = {"device": ["cpu"] * 4}
    (bench / "traffic" / "decode-four.json").write_text(json.dumps(mix))
    (bench / "cells" / "text-small.decode-four.json").write_text(
        json.dumps({"config": "text-small", "traffic": "decode-four"}))
    spec["workloads"].append({"name": "text-small.decode-four",
                              "config": "text-small", "traffic":
                              "decode-four", "chips": 4, "why": "a test"})
    e2e["decode_MBps"]["workloads"].append("text-small.decode-four")
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
    r = core.run_cell("text-small.decode-four", 6, 0.5, False,
                      root=tmp_path, bench_dir=bench, on_card=False)
    assert r["correct"] and r["attempted"] == 3, r["checks"]
    assert r["metrics"]["decode_MBps"]["value"] == 3 * 300_000 / 3.0 / 1e6
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


@pytest.mark.parametrize("n, count, env, shown", [
    (1, 1, None, None),             # exactly the cell's: left as it is
    (4, 4, "0,1,2,3", None),
    (1, 4, None, "0"),              # more: the first n of them
    (4, 8, None, "0,1,2,3"),
    (1, 3, "2, 0,1", "2"),
    (4, 5, "GPU-a,GPU-b,GPU-c,GPU-d,GPU-e", "GPU-a,GPU-b,GPU-c,GPU-d"),
])
def test_a_cell_sees_exactly_its_cards(n, count, env, shown):
    assert core.visible_cards(n, count, env) == shown


@pytest.mark.parametrize("n, count", [(4, 1), (4, 3), (1, 0), (4, 0)])
def test_a_cell_with_fewer_cards_than_it_needs_fails(n, count):
    with pytest.raises(core.NoCard):
        core.visible_cards(n, count, None)


def _cards(monkeypatch, names, visible):
    """torch.cuda as a host with ``names`` cards of which ``visible`` are
    counted before CUDA starts, and nvidia-smi's power limits."""
    import torch

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(core, "visible_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.cuda, "device_count",
        lambda: len(os.environ.get("CUDA_VISIBLE_DEVICES", "").split(","))
        if "CUDA_VISIBLE_DEVICES" in os.environ else len(names))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: names[d])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(uuid=f"u{d}"))
    monkeypatch.setattr(core, "power_limits",
                        lambda: {f"u{d}": f"{700 - 50 * d}.00 W"
                                 for d in range(len(names))})


def test_a_run_names_each_card_and_refuses_mixed_kinds(monkeypatch,
                                                       capsys):
    _cards(monkeypatch, ["H100"] * 4, 4)
    assert core.card(4) == {"kind": "H100", "count": 4, "power_limit":
                            "550.00 W, 600.00 W, 650.00 W, 700.00 W"}
    err = capsys.readouterr().err
    assert "card 3: H100; power limit: 550.00 W" in err
    assert "CUDA_VISIBLE_DEVICES" not in os.environ
    # a one-card cell on the same host sees card 0 alone
    assert core.card(1) == {"kind": "H100", "count": 1,
                            "power_limit": "700.00 W"}
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
    _cards(monkeypatch, ["H100", "H100", "A100", "H100"], 4)
    with pytest.raises(core.NoCard, match="not of one kind"):
        core.card(4)
    _cards(monkeypatch, ["H100"] * 2, 2)
    with pytest.raises(core.NoCard):
        core.card(4)


def test_power_limits_are_found_by_uuid(monkeypatch):
    out = ("GPU-AAAA-1, 700.00 W\nGPU-bbbb-2, 650.00 W\n")
    monkeypatch.setattr(core.subprocess, "run", lambda *a, **k:
                        SimpleNamespace(stdout=out))
    limits = core.power_limits()
    assert [limits.get(core.uuid_key(u), "?") for u in (
        "bbbb-2", "aaaa-1", "GPU-BBBB-2", "cccc")] == [
        "650.00 W", "700.00 W", "650.00 W", "?"]
