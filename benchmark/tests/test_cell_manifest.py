"""BENCHMARK.json against the benchmark's contract, and the files it
names."""

import json
import re

from benchmark.tests.cells import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|embd|head|hidden|intermediate|latent|"
                   r"experts_per_tok")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    b = manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for sect in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[sect]:
            assert NAME.match(e["name"]), e["name"]
            names.append((sect in ("end_to_end", "per_layer"), e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) <= 64 * 1024


def test_cells_and_configs():
    b = manifest()
    confs = {c["name"]: c for c in b["configs"]}
    used = set()
    four = 0
    pairs = set()
    for w in b["workloads"]:
        assert w["config"] in confs and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        four += w["chips"] == 4
    assert used == set(confs)
    assert four <= max(1, len(b["workloads"]) // 4)
    files = set()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert set(conf["limits"]) == {"prior_err", "ego_err", "token_gap",
                                       "rule_mismatch", "stored_mismatch"} \
            | ({"ring_mismatch"} if "ring_check" in conf else set())


def test_metrics():
    b = manifest()
    e2e = {e["name"]: e for e in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in b["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    layers = {}
    for p in b["per_layer"]:
        assert p["moves"] in e2e
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
        # every cell the metric is read in reports the metric it moves
        moved = e2e[p["moves"]].get("workloads", cells)
        assert set(p.get("workloads", cells)) <= set(moved)
        layers.setdefault(p["layer"], p["layer"])
    for cell in cells:
        reported = [e for e in b["end_to_end"]
                    if cell in e.get("workloads", cells)]
        assert {"setup_s"} < {e["name"] for e in reported}
        assert any(cell in p.get("workloads", cells) for p in b["per_layer"])
