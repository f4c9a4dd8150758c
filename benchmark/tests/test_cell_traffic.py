"""The seeded traffic repeats exactly, and every seed gives the same
sizes."""

import json

import numpy as np

from benchmark.harness import seeds
from benchmark.tests.cells import BENCH
from benchmark.traffic import generator as gen

MODEL = json.loads((BENCH / "configs" / "umgen_large_serving.json")
                   .read_text())["model"]


def test_history_repeats_and_varies():
    a = gen.history_tokens(MODEL, 3, 4, 2 ** 31 + 12345)
    b = gen.history_tokens(MODEL, 3, 4, 2 ** 31 + 12345)
    c = gen.history_tokens(MODEL, 3, 4, 7)
    for mod, n, _, _ in MODEL["layout"]:
        assert a[mod].shape == c[mod].shape == (3, 4, n)
        assert np.array_equal(a[mod], b[mod])
    assert not np.array_equal(a["map"], c["map"])


def test_history_is_valid():
    h = gen.history_tokens(MODEL, 2, 5, 99)
    assert h["map"].max() < MODEL["map_vocab_size"]
    boxes = h["bbox3d"].reshape(2, 5, 60, 11)
    assert (boxes[:, :, 40:] == MODEL["bbox3d_vocab_size"] - 1).all()
    assert ((boxes[:, :, :40, 10] >= 1024) & (boxes[:, :, :40, 10] < 1027)
            ).all()


def test_mixes_and_seeds():
    for f in (BENCH / "traffic").glob("*.json"):
        mix = gen.load_mix(f.stem)
        assert 1 <= mix["check_scenes"] <= mix["scenes"]
    assert seeds(5) == seeds(5) and seeds(5) != seeds(6)
    big = seeds(2 ** 33 + 1)
    assert all(0 <= v < 2 ** 63 for v in big.values())
    ids = gen.check_scene_ids(10, 3, 2 ** 32 + 3)
    assert np.array_equal(ids, gen.check_scene_ids(10, 3, 2 ** 32 + 3))
    assert len(set(ids.tolist())) == 3
