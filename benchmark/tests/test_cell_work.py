"""benchmark/work.py against hand counts, and its model-FLOPs count
against torch's FlopCounterMode on the plain reference at a tiny size."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import model as ref


def test_flash_work_by_hand():
    nbytes, ops_s = work.flash_work(1, 4, 4, False, H=2, Dh=8)
    assert nbytes == 2 * 2 * 8 * (8 + 8)
    assert ops_s == pytest.approx(4 * 2 * 16 * 8 / 989e12)
    _, causal = work.flash_work(1, 4, 4, True, H=2, Dh=8)
    assert causal == pytest.approx(4 * 2 * 10 * 8 / 989e12)


def test_decode_work_and_bound_by_hand():
    nbytes, ops_s = work.decode_work("v5", 1, 256, 4, 1, 1, 10)
    assert nbytes == 12 * 256 ** 2 + 15 * 256 * 4 + 11 * 512 + 4 * 256
    assert ops_s == pytest.approx(2 * 12 * 256 ** 2 / 1979e12
                                  + 2 * 11 * 256 / 1979e12
                                  + 2 * 11 * 256 / 989e12)
    w4, _ = work.decode_work("w4", 1, 256, 4, 1, 1, 10)
    assert w4 == 6 * 256 ** 2 + 12 * 256 * 2 * 4 + 15 * 256 * 4 \
        + 11 * 512 + 4 * 256
    b = work.bound(3.35e9, 0.5e-3)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "bytes"


def _tiny_weights(D=16, L=1):
    g = torch.Generator().manual_seed(0)

    def lin(i, o):
        return {"w": torch.randn(L, i, o, generator=g), "b": torch.zeros(L, o)}

    def ln():
        return {"w": torch.ones(L, D)}

    def attn():
        return {"qkv": lin(D, 3 * D), "proj": lin(D, D)}

    def mlp():
        return {"fc": lin(D, 4 * D), "proj": lin(4 * D, D)}

    block = {"ln1": ln(), "sa1": attn(), "ln2": ln(), "mlp1": mlp(),
             "ln3": ln(), "ta": attn(), "ln4": ln(), "mlp2": mlp(),
             "ln5": ln(), "sa2": attn(), "ln6": ln(), "mlp3": mlp()}
    dec = {"ln1": ln(), "self_attn": attn(), "ln2": ln(), "ln3": ln(),
           "cross_attn": {n: lin(D, D) for n in ("q", "k", "v", "proj")},
           "ln4": ln(), "mlp": mlp()}
    return ref.layer(block, 0), ref.layer(dec, 0)


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_tar_block_flops_match_the_counter():
    D, S, T, H = 16, 9, 5, 4
    block, _ = _tiny_weights(D)
    x = torch.randn(T, S, D)
    got = _count(lambda: ref.block_tar(block, x, H))
    # a dense temporal product: every frame's keys counted
    assert got == work._tar_stack(1, D, S, float(T), T)


def test_ego_query_flops_match_the_counter():
    D, S, H = 16, 9, 4
    _, dec = _tiny_weights(D)
    got = _count(lambda: ref.decoder_block(dec, torch.randn(3, D),
                                           torch.randn(S, D), H))
    q = 3
    assert got == 2 * (14 * D * D * q + 2 * D * D * S + 2 * q * q * D
                       + 2 * q * S * D)


def test_frame_flops_by_hand():
    m = {"n_embd": 8, "n_tar_layer": 2, "n_ego_tar_layer": 1,
         "n_map_tar_layer": 1, "n_box_tar_layer": 1, "n_ego_ca_layer": 1,
         "n_oar_layer": 3, "pose_vocab_size": 10, "map_vocab_size": 20,
         "bbox3d_vocab_size": 30, "img_vocab_size": 40, "n_map_embd": 2,
         "n_img_embd": 2}
    segs = {"pose": 3, "map": 4, "bbox3d": 11, "image": 2}
    D, S, sm, sb = 8, 28, 11, 24

    def stack(L, s, keys, T):
        return 2 * L * T * s * (36 * D * D + 4 * s * D + 2 * keys * D)

    def emb(d_in, n):
        return 2 * n * (d_in * 4 * D + 4 * D * D)

    rest = (2 * (14 * D * D * 3 + 2 * D * D * S + 18 * D + 6 * S * D)
            + 2 * 3 * D * 10
            + 2 * 3 * (12 * D * D * S + D * S * (S + 1))
            + 2 * D * (4 * 20 + 11 * 30 + 2 * 40) + 2 * 11 * D * 30
            + emb(2, 4) + emb(2, 2))
    for mode, T, keys in (("cached", 1, 6.0), ("recompute", 6, 3.5)):
        want = (stack(2, S, keys, T) + stack(1, S, keys, T)
                + stack(1, sm, keys, T) + stack(1, sb, keys, T)
                + T * (4 * emb(2, 4) + 2 * emb(2, 2)) + rest)
        assert work.frame_flops(m, segs, mode, 6) == pytest.approx(want)
    assert math.isfinite(work.frame_flops(m, segs, "cached", 8))
