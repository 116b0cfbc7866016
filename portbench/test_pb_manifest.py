"""The manifest against the benchmark's rules: keys, names, units,
cross-references, the metrics each cell reports, and the files each entry
names. Run with ``python -m pytest portbench -q``."""

import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from pb import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|"
                   r"features|width|experts_per_tok)")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

M = manifest.load()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(M) == TOP_KEYS
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    for word in M["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    cells = 24  # a full check with every cell later changes may add
    assert (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert cfg["name"] == c["name"]


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24
    configs = {c["name"] for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (manifest.BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(M["per_layer"]) <= 128
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # Every cell it lists reports the end-to-end metric it moves.
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        assert manifest.reader_path(manifest.BENCH_DIR, m["name"]).is_file()
    assert all(len(v) == 1 for v in layers.values())
    for m in M["end_to_end"]:
        assert manifest.reader_path(manifest.BENCH_DIR, m["name"]).is_file()


def test_every_reader_is_used():
    """No reader file is left that no metric reads."""
    used = {manifest.reader_path(manifest.BENCH_DIR, m["name"]).name
            for m in M["end_to_end"] + M["per_layer"]}
    assert {p.name for p in (manifest.BENCH_DIR / "metrics").glob("*.py")} == used


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_enough(cell):
    c = manifest.cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert set(c.traffic["limits"])


def test_files_named_from_name_characters():
    for path in manifest.BENCH_DIR.rglob("*"):
        if "_cache" in path.parts or "__pycache__" in path.parts:
            continue
        rel = path.relative_to(manifest.ROOT).as_posix()
        assert PATH.match(rel), rel
