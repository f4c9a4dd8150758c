"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device: the
kernels have no CPU mode.  The file imports neither jax nor tests/conftest's
JAX set-up, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from umgen_tpu_torch.models import modules as tnn
from umgen_tpu_torch.ops import decode_kernel as tdk
from umgen_tpu_torch.ops import flash_attention as tfa
from umgen_tpu_torch.ops import gelu as tgelu
from umgen_tpu_torch.params import _Init
from umgen_tpu_torch.runtime.quantize import (pack_decode_weights,
                                              pack_fused_w4,
                                              quantize_params_int8)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,Sq,Sk,causal", [
    (1, 2207, 2207, False), (2, 1031, 1031, False), (1, 1031, 2207, True),
    (1, 100, 64, True)])
def test_flash_kernel_matches_plain(cuda_device, B, Sq, Sk, causal):
    # the kernel rounds unnormalized softmax weights to bf16, the plain
    # version normalized ones: ~2^-9.3 of an output before its bf16
    # rounding, so one ulp apart in about a third of the elements.  No
    # element beyond 4 ulps of the largest output, and a mean error within
    # 2^-8 of the mean |ref| (chip_smoke.py checks that these bounds reject
    # a 15% scale error, a dropped key tile and bf16 value sums)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, S, 16, 48, generator=g, device=cuda_device)
               .bfloat16() for S in (Sq, Sk, Sk))
    n0 = tfa.LAUNCHES["flash_attention"]
    out = tfa.flash_attention(q, k, v, causal)
    assert tfa.LAUNCHES["flash_attention"] == n0 + 1
    ref = tfa.flash_attention_plain(q, k, v, causal)
    if Sq > Sk:   # rows before the first key attend nothing: 0
        ref[:, :Sq - Sk] = 0
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    assert d.max().item() <= 4 * 2.0 ** -8 * r.max().item()
    assert d.mean().item() <= 2.0 ** -8 * r.mean().item()


# the tile edges of the flash kernel: 64-key tiles, 64-row query blocks
FLASH_EDGES = (1, 63, 64, 65, 127, 128, 129, 2207)


def _flash_check(q, k, v, causal):
    """The kernel against the plain version, within the bounds above; rows
    that attend nothing (causal, Sq > Sk) must come out as 0."""
    out = tfa.flash_attention(q, k, v, causal)
    ref = tfa.flash_attention_plain(q, k, v, causal)
    Sq, Sk = q.shape[1], k.shape[1]
    if causal and Sq > Sk:
        ref[:, :Sq - Sk] = 0
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    assert d.max().item() <= 4 * 2.0 ** -8 * r.max().item()
    assert d.mean().item() <= 2.0 ** -8 * r.mean().item()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sk", FLASH_EDGES)
@pytest.mark.parametrize("Sq", FLASH_EDGES)
def test_flash_kernel_tile_edges(cuda_device, Sq, Sk, causal):
    """Query and key counts on either side of the kernel's 64-row blocks
    and 64-key tiles (the ragged last tile is masked, the TMA box's rows
    past Sk are zero fill), causal with Sq < Sk, Sq = Sk and Sq > Sk."""
    g = torch.Generator(device=cuda_device).manual_seed(Sq * 7919 + Sk)
    q, k, v = (torch.randn(1, S, 16, 48, generator=g, device=cuda_device)
               .bfloat16() for S in (Sq, Sk, Sk))
    _flash_check(q, k, v, causal)


@pytest.mark.parametrize("S", [129, 2207])
def test_flash_kernel_fused_views_320_heads(cuda_device, S):
    """q, k, v as views of one fused qkv projection (rows 2304 elements
    apart, the K and V tensor maps on offset bases) at B·H = 320, the
    full-window prefill's batch of 20 frames."""
    g = torch.Generator(device=cuda_device).manual_seed(S)
    qkv = torch.randn(20, S, 3 * 768, generator=g, device=cuda_device)
    q, k, v = (t.reshape(20, S, 16, 48)
               for t in qkv.bfloat16().split(768, dim=-1))
    assert q.stride(1) == 2304 and not k.is_contiguous()
    _flash_check(q, k, v, False)


def _oar_packs(dev, layers=1):
    """int8 and W4A8 packings of one random OAR stack at the model's width
    (d 768, 16 heads of 48), layer norms and biases off their init."""
    g = torch.Generator(device=dev).manual_seed(0)
    oar = _Init(g, dev, torch.bfloat16).block_oar(768, layers)
    for ln in ("ln1", "ln2"):
        oar[ln]["w"] = (1 + 0.1 * torch.randn(layers, 768, generator=g,
                                              device=dev)).bfloat16()
    for lin in ("qkv", "proj"):
        b = oar["attn"][lin]["b"]
        oar["attn"][lin]["b"] = (0.02 * torch.randn(b.shape, generator=g,
                                                    device=dev)).bfloat16()
    v5 = pack_decode_weights(quantize_params_int8({"oar": oar})["oar"])
    return v5, pack_fused_w4({}, oar)["oar_packed"]


def _check_step(packed, name, B, Q, cache_len, dev, exact):
    """One step of `name` against decode_step_plain: h within 2e-2 of its
    scale (one layer), the new K/V rows equal up to a rounding tie, written
    in place, the rest of the caches untouched; bit for bit where
    `exact`."""
    g = torch.Generator(device=dev).manual_seed(1)
    L = packed["vec"].shape[0]
    kv = torch.randint(-100, 101, (2, L, B, 2208, 768), generator=g,
                       device=dev, dtype=torch.int8)
    x = torch.randn(B, Q, 768, generator=g, device=dev).bfloat16()
    kk, vv = kv[0].clone(), kv[1].clone()
    n0 = tdk.LAUNCHES[name]
    h, kk2, vv2 = getattr(tdk, name)(packed, x, kk, vv, cache_len, n_head=16)
    assert tdk.LAUNCHES[name] == n0 + 1
    assert kk2 is kk and vv2 is vv
    ref = tdk.decode_step_plain(packed, x, kv[0], kv[1], cache_len, 16)
    rel = ((h.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert math.isfinite(rel) and rel <= 2e-2
    if exact:
        assert torch.equal(h, ref)
    for got, want in ((kk, kv[0]), (vv, kv[1])):
        new = slice(cache_len, cache_len + Q)
        assert (got[:, :, new].int() - want[:, :, new].int()).abs().max() \
            <= (0 if exact else 1)
        assert torch.equal(got[:, :, :cache_len], want[:, :, :cache_len])
        assert torch.equal(got[:, :, cache_len + Q:],
                           want[:, :, cache_len + Q:])


@pytest.mark.parametrize("B,Q,cache_len", [(1, 1, 0), (2, 1, 900),
                                           (2, 6, 0), (1, 2, 1030)])
def test_decode_kernel_matches_plain(cuda_device, B, Q, cache_len):
    """One int8 layer at the model's width: exact int8 products, the
    prefix attention's float32 sums inside an S-block in another order — a
    few bf16 ulps of h.  A step at cache_len 0 attends only to its own chunk, which
    the kernel and the plain version sum in the same order: h and the new
    rows equal bit for bit."""
    v5, _ = _oar_packs(cuda_device)
    name = "fused_decode_step_v5" if Q == 1 else "fused_decode_step_v5mq"
    _check_step(v5, name, B, Q, cache_len, cuda_device, cache_len == 0)


@pytest.mark.parametrize("Q", [1, 6])
def test_decode_kernel_takes_ten_scenes(cuda_device, Q):
    """B = 10: 10 or 60 rows, past the int8 GEMV's 16-row tile; bit for bit
    at cache_len 0."""
    v5, _ = _oar_packs(cuda_device)
    name = "fused_decode_step_v5" if Q == 1 else "fused_decode_step_v5mq"
    _check_step(v5, name, 10, Q, 0, cuda_device, True)


@pytest.mark.parametrize("B,Q,cache_len", [(1, 1, 0), (10, 1, 0), (2, 6, 0),
                                           (10, 6, 0), (2, 1, 900),
                                           (1, 2, 1030)])
def test_w4_kernel_matches_plain(cuda_device, B, Q, cache_len):
    """One W4A8 layer (group-128 int4 weights, the JAX packing read by the
    plain version, the kernel's repacking by the kernel): exact integer
    products and the same float32 scale order, so bit for bit at
    cache_len 0; a few bf16 ulps of h with a cache prefix."""
    _, w4 = _oar_packs(cuda_device)
    name = "fused_decode_step_w4" if Q == 1 else "fused_decode_step_w4mq"
    _check_step(w4, name, B, Q, cache_len, cuda_device, cache_len == 0)


@pytest.mark.parametrize("kind", ["v5", "w4"])
@pytest.mark.parametrize("Q", [1, 6])
@pytest.mark.parametrize("cache_len", [0, 551, 552, 553, 1100, 2207])
def test_int8_cache_steps_on_the_reference_blocks(cuda_device, kind, Q,
                                                  cache_len):
    """The int8 cache's prefix attention on the reference's S-blocks (552
    rows at S = 2208; cache lengths on either side of a block edge): one
    layer's h within 2e-2 of its scale and bit for bit at cache_len 0, the
    new rows equal up to a rounding tie.  The attention by itself (the layer
    that shows it): the kernel keeps every rounding point of the plain
    version and sums float32 in another order inside a block only, so the
    int8 quantization of y flips only at near-ties — no element beyond 2e-2
    of max |y|, and a mean error within 2^-10 of mean |y|."""
    dev = cuda_device
    cl = min(cache_len, 2208 - Q)
    name = f"fused_decode_step_{kind}{'mq' if Q > 1 else ''}"
    packs = dict(zip(("v5", "w4"), _oar_packs(dev)))
    _check_step(packs[kind], name, 2, Q, cl, dev, cl == 0)
    if cl == 0:
        return
    packed = _visible_packs(dev)[kind]
    kv, _ = _int8_caches(dev, 1, 2)
    g = torch.Generator(device=dev).manual_seed(5)
    x = (2.0 ** -6 * torch.randn(2, Q, 768, generator=g, device=dev)
         ).bfloat16()
    y = getattr(tdk, name)(packed, x, kv[0].clone(), kv[1].clone(), cl,
                           n_head=16)[0].float() - x.float()
    ref = tdk.decode_step_plain(packed, x, kv[0].clone(), kv[1].clone(), cl,
                                16).float() - x.float()
    d, r = (y - ref).abs(), ref.abs()
    assert d.max().item() <= 2e-2 * r.max().item()
    assert d.mean().item() <= 2.0 ** -10 * r.mean().item()


@pytest.mark.parametrize("kind", ["v5", "w4"])
@pytest.mark.parametrize("cache_len", [546, 1098, 2202])
def test_mq_chunks_ending_on_s_block_edges(cuda_device, kind, cache_len):
    """A 6-row chunk of 10 scenes whose last row is an S-block's last (552,
    1104, 2208): the last sub-block of the block holds a few rows.  One
    layer's h within 2e-2 of its scale, the new rows up to a rounding tie;
    the attention by itself within 2e-2 of max |y| and 2^-10 of mean |y|,
    as at any other cache length."""
    dev = cuda_device
    name = f"fused_decode_step_{kind}mq"
    packs = dict(zip(("v5", "w4"), _oar_packs(dev)))
    _check_step(packs[kind], name, 10, 6, cache_len, dev, False)
    packed = _visible_packs(dev)[kind]
    kv, _ = _int8_caches(dev, 1, 10)
    g = torch.Generator(device=dev).manual_seed(5)
    x = (2.0 ** -6 * torch.randn(10, 6, 768, generator=g, device=dev)
         ).bfloat16()
    y = getattr(tdk, name)(packed, x, kv[0].clone(), kv[1].clone(),
                           cache_len, n_head=16)[0].float() - x.float()
    ref = tdk.decode_step_plain(packed, x, kv[0].clone(), kv[1].clone(),
                                cache_len, 16).float() - x.float()
    d, r = (y - ref).abs(), ref.abs()
    assert d.max().item() <= 2e-2 * r.max().item()
    assert d.mean().item() <= 2.0 ** -10 * r.mean().item()


# One near tie, pinned: w4mq, 10 scenes, Q = 6 at cache_len 2202 (the chunk
# ends on the last S-block's last row), on `_int8_caches(seed=16)`.  At
# (scene 7, row 4, column 760) the plain version's y / step lies within
# 2^-16 past the tie -39.5 and rounds to -40; the kernel's float32 value
# sums, in another order inside the S-block, put it on -39's side.
TIE_SEED, TIE_CACHE_LEN, TIE_ELEMENT = 16, 2202, (7, 4, 760)


def test_w4mq_flip_is_a_near_tie(cuda_device, monkeypatch):
    """w4mq's attention output equals the plain version's bit for bit but
    in TIE_ELEMENT, one int8 step apart, where the plain version's y lies
    within 2^-16 of a step from a half step: the one rounding that the
    order of an S-block's float32 sums moves."""
    dev = cuda_device
    packed = _visible_packs(dev)["w4"]
    kv, _ = _int8_caches(dev, 1, 10, TIE_SEED)
    g = torch.Generator(device=dev).manual_seed(5)
    x = (2.0 ** -6 * torch.randn(10, 6, 768, generator=g, device=dev)
         ).bfloat16()
    y = tdk.fused_decode_step_w4mq(packed, x, kv[0].clone(), kv[1].clone(),
                                   TIE_CACHE_LEN, n_head=16)[0].float() \
        - x.float()
    seen = []
    products = tdk._layer_products

    def spy(*args):        # records the y the plain version quantizes
        qkv, proj, fc, pj = products(*args)

        def proj_seen(a):
            seen.append(a)
            return proj(a)

        return qkv, proj_seen, fc, pj

    monkeypatch.setattr(tdk, "_layer_products", spy)
    ref = tdk.decode_step_plain(packed, x, kv[0].clone(), kv[1].clone(),
                                TIE_CACHE_LEN, 16).float() - x.float()
    assert (y != ref).nonzero().tolist() == [list(TIE_ELEMENT)]
    b, q, c = TIE_ELEMENT
    _, sa = tdk._quant_rows(seen[0])
    step = sa[b * 6 + q, 0].item()
    code = seen[0][b * 6 + q, c].item() / step
    assert abs(code + 39.5) <= 2.0 ** -16
    assert round(ref[b, q, c].item() / step) == -40
    assert round(y[b, q, c].item() / step) == -39


def _int4_caches(dev, L, B, seed=1):
    """An int4 cache [kv_k, kv_v, k_scale, v_scale] quantized by
    `quantize_kv_int4` from rows ~N(0, 0.5²)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = 0.5 * torch.randn(2, L, B, 2208, 768, generator=g, device=dev)
    (kp, ks), (vp, vs) = (tdk.quantize_kv_int4(r, 16) for r in rows)
    return [kp, vp, ks, vs]


@pytest.mark.parametrize("kind", ["v5", "w4"])
@pytest.mark.parametrize("Q", [1, 6])
@pytest.mark.parametrize("cache_len", [0, 551, 552, 553, 1100, 2207])
def test_int4_cache_steps_on_the_reference_blocks(cuda_device, kind, Q,
                                                  cache_len):
    """The int4 cache's prefix attention on the reference's S-blocks, the
    int8 twin's cases: one layer's h within 2e-2 of its scale and bit for
    bit at cache_len 0, the new nibbles and scales bit for bit.  The
    attention by itself: the weights bf16(p·vs·(1/7)) are rounded from each
    S-block's p, as the plain version rounds them, and only the float32
    sums inside a block run in another order — no element beyond 2e-2 of
    max |y|, and a mean error within 2^-10 of mean |y|."""
    dev = cuda_device
    cl = min(cache_len, 2208 - Q)
    name = f"fused_decode_step_{kind}{'mq' if Q > 1 else ''}i4"
    packs = dict(zip(("v5", "w4"), _oar_packs(dev)))
    _check_step_i4(packs[kind], name, 2, Q, cl, dev, cl == 0)
    if cl == 0:
        return
    packed = _visible_packs(dev)[kind]
    cache = _int4_caches(dev, 1, 2)
    g = torch.Generator(device=dev).manual_seed(5)
    x = (2.0 ** -6 * torch.randn(2, Q, 768, generator=g, device=dev)
         ).bfloat16()
    y = getattr(tdk, name)(packed, x, *(t.clone() for t in cache), cl,
                           n_head=16)[0].float() - x.float()
    c = [t.clone() for t in cache]
    ref = tdk.decode_step_plain(packed, x, c[0], c[1], cl, 16, c[2],
                                c[3]).float() - x.float()
    d, r = (y - ref).abs(), ref.abs()
    assert d.max().item() <= 2e-2 * r.max().item()
    assert d.mean().item() <= 2.0 ** -10 * r.mean().item()


def test_w4_gemv_row_tiles_bit_for_bit(cuda_device):
    """The W4 GEMV stages the rows' activations a tile at a time (fourteen
    rows of 3072 at the MLP's second product): 80 rows, two layers, at
    cache_len 0 the step must equal the plain version bit for bit — the
    integer sums are exact and the group scales are applied in the
    reference's pair order, so the redesigned GEMV keeps the old bits."""
    _, w4 = _oar_packs(cuda_device, layers=2)
    _check_step(w4, "fused_decode_step_w4mq", 10, 8, 0, cuda_device, True)


def _check_step_i4(packed, name, B, Q, cache_len, dev, exact, S=2208):
    """One step of an int4-cache wrapper against decode_step_plain on a
    random cache quantized by `quantize_kv_int4`: h within 2e-2 of its scale
    (one layer); the new rows' nibbles and scales written in place and —
    one layer sees identical inputs on both sides — equal bit for bit; the
    rest of the caches untouched."""
    g = torch.Generator(device=dev).manual_seed(1)
    L = packed["vec"].shape[0]
    rows = 0.5 * torch.randn(2, L, B, S, 768, generator=g, device=dev)
    (kp, ks), (vp, vs) = (tdk.quantize_kv_int4(r, 16) for r in rows)
    x = torch.randn(B, Q, 768, generator=g, device=dev).bfloat16()
    got = [t.clone() for t in (kp, vp, ks, vs)]
    n0 = tdk.LAUNCHES[name]
    out = getattr(tdk, name)(packed, x, *got, cache_len, n_head=16)
    assert tdk.LAUNCHES[name] == n0 + 1
    assert all(o is t for o, t in zip(out[1:], got))
    ref = tdk.decode_step_plain(packed, x, kp, vp, cache_len, 16, ks, vs)
    torch.cuda.synchronize()
    rel = ((out[0].float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert math.isfinite(rel) and rel <= 2e-2
    if exact:
        assert torch.equal(out[0], ref)
    for g_, want in zip(got, (kp, vp, ks, vs)):
        assert torch.equal(g_, want)
    new = ks[:, :, cache_len:cache_len + Q]
    assert new.min() > 0        # the step did write the new rows' scales


@pytest.mark.parametrize("kind", ["v5", "w4"])
@pytest.mark.parametrize("B,Q,cache_len", [(1, 1, 0), (10, 1, 0), (2, 6, 0),
                                           (10, 6, 0), (2, 1, 900),
                                           (1, 2, 1030), (1, 8, 2200)])
def test_i4_kernel_matches_plain(cuda_device, kind, B, Q, cache_len):
    """v5i4 / v5mqi4 / w4i4 / w4mqi4, one layer at the model's width: the
    prep kernel's nibbles and scales equal `quantize_kv_int4`'s bit for bit,
    h bit for bit at cache_len 0 and within a few bf16 ulps with a prefix
    (the kernel folds the prefix in row by row, the plain version in the
    reference's blocks)."""
    packs = dict(zip(("v5", "w4"), _oar_packs(cuda_device)))
    name = f"fused_decode_step_{kind}{'mq' if Q > 1 else ''}i4"
    _check_step_i4(packs[kind], name, B, Q, cache_len, cuda_device,
                   cache_len == 0)


def _visible_packs(dev):
    """`_oar_packs` of one layer that shows its attention: the output
    projection the identity without bias, the MLP's second product zero, so
    that the layer returns x + the attention output."""
    g = torch.Generator(device=dev).manual_seed(0)
    oar = _Init(g, dev, torch.bfloat16).block_oar(768, 1)
    b = oar["attn"]["qkv"]["b"]
    oar["attn"]["qkv"]["b"] = (0.02 * torch.randn(b.shape, generator=g,
                                                  device=dev)).bfloat16()
    oar["attn"]["proj"]["w"] = torch.eye(768, device=dev).bfloat16()[None]
    oar["mlp"]["proj"]["w"] = torch.zeros_like(oar["mlp"]["proj"]["w"])
    v5 = pack_decode_weights(quantize_params_int8({"oar": oar})["oar"])
    return {"v5": v5, "w4": pack_fused_w4({}, oar)["oar_packed"]}


@pytest.mark.parametrize("kind", ["v5", "w4"])
@pytest.mark.parametrize("B,Q,cache_len", [(2, 1, 900), (1, 6, 1100),
                                           (10, 2, 2206)])
def test_i4_prefix_attention_matches_plain(cuda_device, kind, B, Q,
                                           cache_len):
    """The int4 prefix attention itself, which is ~0.6% of max |h| through
    a layer of random weights: through the layer that shows it, on a small
    x, h - x is the attention output y.  Kernel and plain version round the
    softmax weights to bf16 from each S-block's p and differ at most in the
    order of float32 sums inside a block, which could flip the int8
    quantization of y (step 1/127 of a row's max) at a near tie: no element
    beyond 2e-2 of max |y|, mean error within 2^-10 of mean |y|.  Three
    wrong prefixes given to the plain version — the scale planes swapped,
    the low nibble read for the heads >= H/2, a 32-row block dropped — must
    fail that."""
    dev = cuda_device
    packed = _visible_packs(dev)[kind]
    name = f"fused_decode_step_{kind}{'mq' if Q > 1 else ''}i4"
    g = torch.Generator(device=dev).manual_seed(1)
    rows = 0.5 * torch.randn(2, 1, B, 2208, 768, generator=g, device=dev)
    (kp, ks), (vp, vs) = (tdk.quantize_kv_int4(r, 16) for r in rows)
    x = (2.0 ** -6 * torch.randn(B, Q, 768, generator=g, device=dev)
         ).bfloat16()

    def plain(*cache, at=cache_len):
        return tdk.decode_step_plain(packed, x, *(t.clone() for t in
                                                  cache[:2]), at, 16,
                                     *(t.clone() for t in cache[2:])
                                     ).float() - x.float()

    def ok(y, ref):
        d, r = (y - ref).abs(), ref.abs()
        return (d.max() <= 2e-2 * r.max()
                and d.mean() <= 2.0 ** -10 * r.mean()).item()

    def drop(t, a=512, n=32):  # rows [a, a + n) gone, the row count kept
        return torch.cat([t[:, :, :a], t[:, :, a + n:], t[:, :, :n]], dim=2)

    y = getattr(tdk, name)(packed, x, *(t.clone() for t in
                                        (kp, vp, ks, vs)), cache_len,
                           n_head=16)[0].float() - x.float()
    assert ok(y, plain(kp, vp, ks, vs))
    assert not ok(y, plain(kp, vp, vs, ks))
    assert not ok(y, plain((kp << 4) | (kp & 0xF), (vp << 4) | (vp & 0xF),
                           ks, vs))
    assert not ok(y, plain(*(drop(t) for t in (kp, vp, ks, vs)),
                           at=cache_len - 32))


def test_i4_kernel_takes_segment_views(cuda_device):
    """A prefix view of the packed cache and of the scale planes (as
    `Rollout._sliced` hands out): the kernel takes their strides, and the
    new rows land in the full tensors."""
    v5, _ = _oar_packs(cuda_device, layers=2)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    rows = 0.5 * torch.randn(2, 2, 3, 2208, 768, generator=g,
                             device=cuda_device)
    (kp, ks), (vp, vs) = (tdk.quantize_kv_int4(r, 16) for r in rows)
    x = torch.randn(3, 1, 768, generator=g, device=cuda_device).bfloat16()
    full = [t.clone() for t in (kp, vp, ks, vs)]
    views = [t[:, :, :1032] for t in full]
    assert not views[0].is_contiguous()
    h, *_ = tdk.fused_decode_step_v5i4(v5, x, *views, 1000, n_head=16)
    ref_c = [t[:, :, :1032].clone() for t in (kp, vp, ks, vs)]
    ref = tdk.decode_step_plain(v5, x, ref_c[0], ref_c[1], 1000, 16,
                                ref_c[2], ref_c[3])
    torch.cuda.synchronize()
    rel = ((h.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert rel.item() <= 2e-2
    for f, r, orig in zip(full, ref_c, (kp, vp, ks, vs)):
        assert torch.equal(f[0, :, :1032], r[0])          # layer 0: equal
        assert not torch.equal(f[:, :, 1000], orig[:, :, 1000])
        assert torch.equal(f[:, :, 1032:], orig[:, :, 1032:])
        assert torch.equal(f[:, :, :1000], orig[:, :, :1000])


def test_plain_divides_as_the_kernel(cuda_device):
    """The plain decode step's divisions by constants (layer norm's 1/n,
    the quantizers' 1/127, GELU's 1/sqrt(2)) are IEEE divisions on the
    card, as the kernel's are — not PyTorch's CUDA product with a rounded
    reciprocal, which is one bit off for some inputs and broke the exact
    cache_len-0 check at B = 10."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(1 << 16, generator=g, device=cuda_device) * 8
    for c in (768.0, 3072.0, 127.0, 1.41421353816986083984375):
        ieee = (x.cpu().double() / c).float()     # correctly rounded
        assert torch.equal(tdk._div(x, c).cpu(), ieee), c


# ---------------------------------------------------------------------------
# v3, v4, v6, v7 (integer logits) and v1, v2 (dense bf16 / fp8 / int8 cache)
# ---------------------------------------------------------------------------
def _int8_caches(dev, L, B, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = torch.randint(-100, 101, (2, L, B, 2208, 768), generator=g,
                       device=dev, dtype=torch.int8)
    x = torch.randn(B, 1, 768, generator=g, device=dev).bfloat16()
    return kv, x


@pytest.mark.parametrize("B,cache_len", [(1, 0), (2, 900), (10, 2207)])
def test_v3_v4_v6_v7_kernels(cuda_device, B, cache_len):
    """One layer at the model's width.  v3 and v4 run v5's kernel on the
    flat view of their 5-D caches: h and the new rows equal v5's bit for
    bit, and the 5-D caches passed come back written in place.  v6 puts the
    new rows on the grid from float32: h equals v5's, rows at most one step
    from v5's and equal to the plain version's.  v7 (one query scale per
    (scene, head)) against its plain version: bit for bit at cache_len 0,
    within 2e-2 of h's scale with a prefix."""
    from umgen_tpu_torch.runtime.quantize import pack_fused_oar_v4
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    oar = _Init(g, dev, torch.bfloat16).block_oar(768, 1)
    q = quantize_params_int8({"oar": oar})["oar"]
    v5, v4 = pack_decode_weights(q), pack_fused_oar_v4(q)
    kv, x = _int8_caches(dev, 1, B)
    k5, v5c = kv[0].clone(), kv[1].clone()
    h5 = tdk.fused_decode_step_v5(v5, x, k5, v5c, cache_len, n_head=16)[0]
    for name, packed in (("fused_decode_step_v3", v5),
                         ("fused_decode_step_v4", v4)):
        kk = kv[0].clone().view(1, B, 2208, 16, 48)
        vv = kv[1].clone().view(1, B, 2208, 16, 48)
        n0 = tdk.LAUNCHES[name]
        h, kk2, vv2 = getattr(tdk, name)(packed, x, kk, vv, cache_len,
                                         n_head=16)
        assert tdk.LAUNCHES[name] == n0 + 1
        assert kk2 is kk and vv2 is vv and kk.ndim == 5
        assert torch.equal(h, h5)
        assert torch.equal(kk.flatten(3), k5) and torch.equal(vv.flatten(3),
                                                              v5c)
    with pytest.raises(ValueError, match="contiguous"):
        bad = kv[0].clone().view(1, B, 2208, 16, 48).transpose(3, 4)
        tdk.fused_decode_step_v3(v5, x, bad, bad.clone(), cache_len,
                                 n_head=16)
    k6, v6 = kv[0].clone(), kv[1].clone()
    h6 = tdk.fused_decode_step_v6(v5, x, k6, v6, cache_len, n_head=16)[0]
    kp, vp = kv[0].clone(), kv[1].clone()
    tdk.decode_step_plain(v5, x, kp, vp, cache_len, 16, rows_f32=True)
    assert torch.equal(h6, h5)
    assert torch.equal(k6, kp) and torch.equal(v6, vp)
    assert (k6.int() - k5.int()).abs().max() <= 1
    k7, v7 = kv[0].clone(), kv[1].clone()
    h7 = tdk.fused_decode_step_v7(v5, x, k7, v7, cache_len, n_head=16)[0]
    ref = tdk.decode_step_plain(v5, x, kp, vp, cache_len, 16,
                                head_scale=True)
    rel = ((h7.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert rel <= 2e-2 and (cache_len or torch.equal(h7, ref))
    assert torch.equal(k7, k5) and torch.equal(v7, v5c)


def _dense_caches(dev, dtype, L, B, seed=1):
    """Random dense caches (values ~N(0, 0.5²)) and x."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kvf = 0.5 * torch.randn(2, L, B, 2208, 768, generator=g, device=dev)
    x = torch.randn(B, 1, 768, generator=g, device=dev).bfloat16()
    return [tdk.kv_store(t, dtype) for t in kvf], x


def _dense_call(name, v5, oar_q, x, kk, vv, cl):
    first = oar_q if name == "fused_decode_step" else v5
    return getattr(tdk, name)(first, x, kk, vv, cl, n_head=16)


@pytest.mark.parametrize("name,dtype", [
    ("fused_decode_step_v2", torch.bfloat16),
    ("fused_decode_step_v2", torch.float8_e4m3fn),
    ("fused_decode_step_v2", torch.int8),
    ("fused_decode_step", torch.bfloat16),
    ("fused_decode_step", torch.float8_e4m3fn)])
@pytest.mark.parametrize("B,cache_len", [(1, 0), (2, 900), (1, 2207)])
def test_dense_kernels_match_plain(cuda_device, name, dtype, B, cache_len):
    """v2 and v1, one layer at the model's width, every storage type: the
    kernel keeps the plain version's S-blocks and rounding points, so only
    the order of float32 sums differs — h within 2e-2 of its scale, bit for
    bit at cache_len 0; the new rows (one layer: identical inputs) equal in
    the cache's type, written in place, the rest untouched; a 5-D view of
    the caches is taken as it is."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    oar_q = quantize_params_int8(
        {"oar": _Init(g, dev, torch.bfloat16).block_oar(768, 1)})["oar"]
    v5 = pack_decode_weights(oar_q)
    (kc, vc), x = _dense_caches(dev, dtype, 1, B)
    kk, vv = kc.clone(), vc.clone()
    k5d = kk.view(1, B, 2208, 16, 48)
    n0 = tdk.LAUNCHES[name]
    h, kk2, vv2 = _dense_call(name, v5, oar_q, x, k5d, vv, cache_len)
    assert tdk.LAUNCHES[name] == n0 + 1 and kk2 is k5d and vv2 is vv
    ref = tdk.decode_step_dense_plain(v5, x, kc, vc, cache_len, 16,
                                      whole_s=name == "fused_decode_step")
    rel = ((h.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert math.isfinite(rel) and rel <= 2e-2
    assert cache_len or torch.equal(h, ref)
    for got, want in ((kk, kc), (vv, vc)):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert kc[:, :, cache_len].float().abs().max() > 0


@pytest.mark.parametrize("name,dtype", [
    ("fused_decode_step_v2", torch.bfloat16),
    ("fused_decode_step_v2", torch.float8_e4m3fn),
    ("fused_decode_step_v2", torch.int8),
    ("fused_decode_step", torch.bfloat16),
    ("fused_decode_step", torch.float8_e4m3fn),
    ("fused_decode_step_v7", torch.int8)])
@pytest.mark.parametrize("B,cache_len", [(2, 900), (1, 2207)])
def test_variant_prefix_attention_matches_plain(cuda_device, name, dtype, B,
                                                cache_len):
    """The prefix attention of v1, v2 and v7 read by itself (the layer whose
    output projection is the identity; see the int4 test above): max error
    within 2e-2 of max |y|, mean within 2^-7 of mean |y|.  A prefix one
    32-row block short must fail that."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    oar = _Init(g, dev, torch.bfloat16).block_oar(768, 1)
    oar["attn"]["proj"]["w"] = torch.eye(768, device=dev).bfloat16()[None]
    oar["mlp"]["proj"]["w"] = torch.zeros_like(oar["mlp"]["proj"]["w"])
    oar_q = quantize_params_int8({"oar": oar})["oar"]
    v5 = pack_decode_weights(oar_q)
    if name.endswith("v7"):
        (kc, vc), x = _int8_caches(dev, 1, B)
    else:
        (kc, vc), x = _dense_caches(dev, dtype, 1, B)
    x = (x.float() * 2.0 ** -6).bfloat16()

    def plain(k, v, cl):
        if name.endswith("v7"):
            h = tdk.decode_step_plain(v5, x, k.clone(), v.clone(), cl, 16,
                                      head_scale=True)
        else:
            h = tdk.decode_step_dense_plain(
                v5, x, k.clone(), v.clone(), cl, 16,
                whole_s=name == "fused_decode_step")
        return h.float() - x.float()

    def ok(y, ref):
        d, r = (y - ref).abs(), ref.abs()
        return (d.max() <= 2e-2 * r.max()
                and d.mean() <= 2.0 ** -7 * r.mean()).item()

    y = _dense_call(name, v5, oar_q, x, kc.clone(), vc.clone(),
                    cache_len)[0].float() - x.float()
    assert ok(y, plain(kc, vc, cache_len))
    assert not ok(y, plain(kc[:, :, 32:], vc[:, :, 32:], cache_len - 32))


def test_dense_kernel_takes_segment_views(cuda_device):
    """A prefix view of a bf16 cache (as `Rollout._sliced` hands out, S =
    1032: three S-blocks of 344 rows): the kernel takes its strides, the
    new row lands in the full cache."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    v5 = pack_decode_weights(quantize_params_int8(
        {"oar": _Init(g, dev, torch.bfloat16).block_oar(768, 2)})["oar"])
    (kc, vc), x = _dense_caches(dev, torch.bfloat16, 2, 3)
    fk, fv = kc.clone(), vc.clone()
    h, *_ = tdk.fused_decode_step_v2(v5, x, fk[:, :, :1032], fv[:, :, :1032],
                                     1000, n_head=16)
    rk, rv = kc[:, :, :1032].clone(), vc[:, :, :1032].clone()
    ref = tdk.decode_step_dense_plain(v5, x, rk, rv, 1000, 16)
    rel = ((h.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert rel.item() <= 2e-2
    for f, r, orig in ((fk, rk, kc), (fv, rv, vc)):
        assert torch.equal(f[0, :, :1032], r[0])          # layer 0: equal
        assert not torch.equal(f[:, :, 1000], orig[:, :, 1000])
        assert torch.equal(f[:, :, 1032:], orig[:, :, 1032:])
        assert torch.equal(f[:, :, :1000], orig[:, :, :1000])


def test_fp8_rows_saturate_as_the_plain_version(cuda_device):
    """K/V beyond ±448 (a K bias of 600 here) saturate in the kernel's fp8
    store exactly as in `kv_store` on the card; JAX's conversion would give
    NaN (ROADMAP.md Queue 3)."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    oar = _Init(g, dev, torch.bfloat16).block_oar(768, 1)
    oar["attn"]["qkv"]["b"][:, 768:1536] = 600.0
    v5 = pack_decode_weights(quantize_params_int8({"oar": oar})["oar"])
    (kc, vc), x = _dense_caches(dev, torch.float8_e4m3fn, 1, 1)
    kk, vv = kc.clone(), vc.clone()
    tdk.fused_decode_step_v2(v5, x, kk, vv, 5, n_head=16)
    tdk.decode_step_dense_plain(v5, x, kc, vc, 5, 16)
    assert torch.equal(kk.view(torch.uint8), kc.view(torch.uint8))
    assert kk[0, 0, 5].float().max().item() == 448.0


# ---------------------------------------------------------------------------
# the int8 GEMV by itself, and v2 / v1 at the edges of their blocks
# ---------------------------------------------------------------------------
# (K, N) of a layer's four products: qkv, proj, fc, pj
GEMV_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
EPI_STORE, EPI_GELU, EPI_RESID = 0, 1, 2


def _gemv_i8(R, wt, ws, bias, epi, out, aq=None, sa=None, x=None, lnw=None):
    """`umgen_gemv_i8` of csrc/decode_step.cu: the steps' int8 product on
    quantized rows (aq, sa) or on float rows x that it normalizes (lnw) and
    quantizes in its own blocks; out written (EPI_RESID: updated) in place."""
    from umgen_tpu_torch.ops import _cuda
    V = _cuda.VOIDP
    fn = _cuda.function("umgen_gemv_i8", [V, V, V, V, _cuda.INT, V, _cuda.INT,
                                          _cuda.INT, V, V, _cuda.INT, V, V])

    def ptr(t):
        return None if t is None else t.data_ptr()

    N, K = wt.shape
    err = fn(ptr(aq), ptr(sa), ptr(x), ptr(lnw), R, wt.data_ptr(), K, N,
             ws.data_ptr(), ptr(bias), epi, out.data_ptr(),
             _cuda.stream_ptr(out))
    _cuda.check(err, "int8 GEMV")
    torch.cuda.synchronize()


@pytest.mark.parametrize("epi", [EPI_STORE, EPI_GELU, EPI_RESID])
@pytest.mark.parametrize("K,N", GEMV_SHAPES)
@pytest.mark.parametrize("R", [1, 2, 6, 10, 60])
def test_int8_gemv_bit_for_bit(cuda_device, R, K, N, epi):
    """The int8 GEMV of every int8-weight step, at every row count that
    reaches it (B·Q = 1, 2, 6, 10, 60), each product of a layer and each
    epilogue: the integer sums are exact in any order and the epilogue is
    acc·sa·ws (+ b) in `_qdot`'s order, so the output equals the plain
    version's bit for bit (the GEMV it replaced was bit for bit too: the
    steps' cache_len-0 checks).  At one and two rows the GEMV also takes
    the float rows and normalizes (layer norm for K = 768, none for the MLP's
    3072) and quantizes them in its own blocks: equal bits again, which
    holds each row's int8 values and scale to `_ln` + `_quant_rows`."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(1000 * R + K + N + epi)
    x = torch.randn(R, K, generator=g, device=dev) * 1.7
    x[:, :4] *= 40            # a few large activations, as GELU's outputs
    wt = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                       dtype=torch.int8)
    ws = 1e-3 * (0.5 + torch.rand(N, generator=g, device=dev))
    bias = (None if epi == EPI_GELU
            else 0.02 * torch.randn(N, generator=g, device=dev))
    lnw = ((1 + 0.1 * torch.randn(K, generator=g, device=dev)).bfloat16()
           .float() if K == 768 else None)
    h0 = torch.randn(R, N, generator=g, device=dev).bfloat16().float()
    a = tdk._ln(x, lnw) if lnw is not None else x
    aq, sa = tdk._quant_rows(a)
    y = tdk._qdot(a, wt, ws, bias)
    want = {EPI_STORE: y, EPI_GELU: tdk._gelu_as(y),
            EPI_RESID: tdk._bf16_add(h0, y)}[epi]
    out = h0.clone()
    _gemv_i8(R, wt, ws, bias, epi, out, aq=aq.to(torch.int8).contiguous(),
             sa=sa.reshape(R).contiguous())
    assert torch.equal(out, want)
    if R <= 2:
        out = h0.clone()
        _gemv_i8(R, wt, ws, bias, epi, out, x=x, lnw=lnw)
        assert torch.equal(out, want)


def _dense_visible_v5(dev):
    """One int8 layer that shows its attention (see `_visible_packs`), as
    pack_decode_weights' blocks and the unpacked int8 tree v1 takes."""
    g = torch.Generator(device=dev).manual_seed(0)
    oar = _Init(g, dev, torch.bfloat16).block_oar(768, 1)
    oar["attn"]["proj"]["w"] = torch.eye(768, device=dev).bfloat16()[None]
    oar["mlp"]["proj"]["w"] = torch.zeros_like(oar["mlp"]["proj"]["w"])
    oar_q = quantize_params_int8({"oar": oar})["oar"]
    return pack_decode_weights(oar_q), oar_q


def _check_dense_step(dev, name, dtype, B, cache_len):
    """One layer of v2 / v1 against `decode_step_dense_plain`: h within 2e-2
    of its scale and bit for bit at cache_len 0, the caches' bytes equal
    after the step (the new row in the cache's type, the rest untouched);
    then the prefix attention by itself, through the layer that shows it:
    no element beyond 2e-2 of max |y|, a mean error within 2^-10 of mean
    |y| (the S-block steps' bounds: only the order of the float32 sums
    inside a block differs from the plain version)."""
    whole = name == "fused_decode_step"
    g = torch.Generator(device=dev).manual_seed(0)
    oar_q = quantize_params_int8(
        {"oar": _Init(g, dev, torch.bfloat16).block_oar(768, 1)})["oar"]
    v5 = pack_decode_weights(oar_q)
    (kc, vc), x = _dense_caches(dev, dtype, 1, B, seed=cache_len + 7)
    kk, vv = kc.clone(), vc.clone()
    n0 = tdk.LAUNCHES[name]
    h = _dense_call(name, v5, oar_q, x, kk, vv, cache_len)[0]
    assert tdk.LAUNCHES[name] == n0 + 1
    ref = tdk.decode_step_dense_plain(v5, x, kc, vc, cache_len, 16,
                                      whole_s=whole)
    rel = ((h.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert math.isfinite(rel) and rel <= 2e-2
    assert cache_len or torch.equal(h, ref)
    for got, want in ((kk, kc), (vv, vc)):
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    if cache_len == 0:
        return
    vis, vis_q = _dense_visible_v5(dev)
    xs = (x.float() * 2.0 ** -6).bfloat16()
    (kc, vc), _ = _dense_caches(dev, dtype, 1, B, seed=cache_len + 8)
    y = _dense_call(name, vis, vis_q, xs, kc.clone(), vc.clone(),
                    cache_len)[0].float() - xs.float()
    ref = tdk.decode_step_dense_plain(vis, xs, kc.clone(), vc.clone(),
                                      cache_len, 16, whole_s=whole
                                      ).float() - xs.float()
    d, r = (y - ref).abs(), ref.abs()
    assert d.max().item() <= 2e-2 * r.max().item()
    assert d.mean().item() <= 2.0 ** -10 * r.mean().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn,
                                   torch.int8])
@pytest.mark.parametrize("cache_len", [31, 32, 33, 551, 552, 553, 2207])
@pytest.mark.parametrize("B", [1, 3])
def test_v2_on_block_edges(cuda_device, dtype, cache_len, B):
    """v2 on its three storage types, at the edges of its 32-row sub-blocks
    and its 552-row S-blocks (S = 2208) and at a full cache, one and three
    scenes (see `_check_dense_step`)."""
    _check_dense_step(cuda_device, "fused_decode_step_v2", dtype, B,
                      cache_len)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("cache_len", [0, 1, 1100, 2207])
def test_v1_on_its_one_block(cuda_device, dtype, cache_len):
    """v1 (one block over all of S, normalized weights): an empty cache,
    one row, half and all of it (69 sub-blocks under one denominator)."""
    _check_dense_step(cuda_device, "fused_decode_step", dtype, 1, cache_len)


# ---------------------------------------------------------------------------
# the reference checkpoint importer and the control path on the card
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_importer_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """A reference-format checkpoint of seeded debug-scale weights (full
    width, one layer a stack) loaded on the card and on the CPU: the same
    tree, leaf for leaf bit for bit, and the exported weights come back
    as they were."""
    from chip_smoke import export_reference_state_dict
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.torch_import import load_umgen_checkpoint
    cfg = ModelConfig().scaled("debug")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "UMGen.pt")
    torch.save({"module": export_reference_state_dict(params)}, path)
    cpu = dict(_leaves(load_umgen_checkpoint(path, cfg, device="cpu")))
    card = dict(_leaves(load_umgen_checkpoint(path, cfg,
                                              device=cuda_device)))
    assert sorted(cpu) == sorted(card)
    for k in cpu:
        assert card[k].device.type == cuda_device.type, k
        assert card[k].dtype == cpu[k].dtype and torch.equal(
            card[k].cpu(), cpu[k]), k
    for k, v in _leaves(params):
        if not k.startswith("/buffers"):
            assert torch.equal(cpu[k], v), k


def test_control_frame_on_the_card_matches_the_cpu(cuda_device):
    """One agent-control frame at debug scale (full width, one layer a
    stack; the fused int8 decode, bf16 rings, greedy): the ego action and
    three agents' boxes of a later frame forced, map and image
    teacher-forced, through `frame_step_prefill` on the card and, replaying
    the card's decisions, on the CPU.  The tokens equal, the priors and
    every decision's logits within chip_smoke.py phase d's bounds (2e-2 and
    5e-2 of their largest magnitude)."""
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.models.sampling import greedy_sample
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import pack_fused
    cfg = ModelConfig(sample_method="greedy", tar_cache_dtype="bfloat16",
                      oar_cache_dtype="int8", fused_oar_kernel=True,
                      tar_cache_window=20).scaled("debug")
    model = UMGen(cfg)
    params = pack_fused(quantize_params_int8(init_params(
        cfg, torch.Generator().manual_seed(3), "cpu")))
    cond = make_token_batch(model.layout, T=2, B=1, seed=0, config=cfg)
    nxt = make_token_batch(model.layout, T=1, B=1, seed=1, config=cfg)
    ctrl = torch.full((1, 660), -1, dtype=torch.long)
    ctrl[:, :33] = torch.as_tensor(nxt["bbox3d"][:, 0, :33])

    def run(dev, sampler):
        ro = Rollout(model)
        ro._samplers = {m: sampler for m in ro._samplers}
        tree = _to(params, dev)
        inputs = {m: torch.as_tensor(v, dtype=torch.long, device=dev)
                  for m, v in cond.items()}
        out, _ = ro.frame_step_prefill(
            tree, inputs, torch.Generator(dev),
            pose_override=torch.as_tensor(nxt["pose"][:, 0],
                                          device=dev).long(),
            control_bbox=ctrl.to(dev),
            forced_tokens={m: torch.as_tensor(nxt[m][:, 0], device=dev)
                           .long() for m in ("map", "image")})
        return out

    card_logits, card_tokens = [], []

    def card_sampler(g, logits):
        tok = greedy_sample(g, logits)
        card_logits.append(logits.float().cpu())
        card_tokens.append(tok.cpu())
        return tok

    replay, cpu_logits = iter(card_tokens), []

    def cpu_sampler(g, logits):
        cpu_logits.append(logits.float())
        return next(replay)

    card = run(cuda_device, card_sampler)
    cpu = run(torch.device("cpu"), cpu_sampler)
    assert len(card_logits) == len(cpu_logits) == 3 * 660
    assert torch.equal(card.tokens.cpu(), cpu.tokens)

    def rel(a, b):
        fin = torch.isfinite(b)
        assert torch.equal(fin, torch.isfinite(a))
        return ((a - b)[fin].abs().max() / b[fin].abs().max()).item()

    assert rel(card.prior_seq.float().cpu(), cpu.prior_seq.float()) <= 2e-2
    assert max(rel(a, b) for a, b in zip(card_logits, cpu_logits)) <= 5e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# speculative verify chunks: Q = 8 (Q·H = 128) on the segment views the
# chunks read, K = 8 slack rows past the segment's end (the bbox segment's,
# S = 1693 + 8, and the image segment's last chunk, S = 2207 + 8, rows
# 2205..2212 written)
VERIFY_CASES = [(1, 1100, 1701), (10, 1100, 1701), (1, 2205, 2215),
                (10, 2205, 2215)]


@pytest.mark.parametrize("kind", ["v5", "w4"])
@pytest.mark.parametrize("cache", ["int8", "int4"])
@pytest.mark.parametrize("B,cache_len,S", VERIFY_CASES)
def test_mq_kernels_take_verify_chunks(cuda_device, kind, cache, B,
                                       cache_len, S):
    """v5mq / w4mq / v5mqi4 / w4mqi4 at Q = 8 on a view with slack rows,
    one layer at the model's width, against the plain version: h within
    2e-2 of its scale (chip_smoke.py phase b's one-layer bound), the 8 new
    rows equal up to a rounding tie (int8) or bit for bit (int4 nibbles and
    scales), every other row — the slack rows past the chunk too —
    untouched."""
    dev = cuda_device
    packs = dict(zip(("v5", "w4"), _oar_packs(dev)))
    packed = packs[kind]
    g = torch.Generator(device=dev).manual_seed(3)
    if cache == "int8":
        kv = list(torch.randint(-100, 101, (2, 1, B, S, 768), generator=g,
                                device=dev, dtype=torch.int8))
        name = f"fused_decode_step_{kind}mq"
    else:
        rows = 0.5 * torch.randn(2, 1, B, S, 768, generator=g, device=dev)
        (kp, ks), (vp, vs) = (tdk.quantize_kv_int4(r, 16) for r in rows)
        kv = [kp, vp, ks, vs]
        name = f"fused_decode_step_{kind}mqi4"
    x = torch.randn(B, 8, 768, generator=g, device=dev).bfloat16()
    mine = [t.clone() for t in kv]
    n0 = tdk.LAUNCHES[name]
    h = getattr(tdk, name)(packed, x, *mine, cache_len, n_head=16)[0]
    assert tdk.LAUNCHES[name] == n0 + 1
    ref_kv = [t.clone() for t in kv]
    ref = tdk.decode_step_plain(packed, x, ref_kv[0], ref_kv[1], cache_len,
                                16, *ref_kv[2:])
    rel = ((h.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert math.isfinite(rel) and rel <= 2e-2
    new = slice(cache_len, cache_len + 8)
    for got, want in zip(mine, ref_kv):
        if cache == "int8":
            d = (got[:, :, new].int() - want[:, :, new].int()).abs().max()
            assert d <= 1
        else:
            assert torch.equal(got[:, :, new], want[:, :, new])
    for got, orig in zip(mine, kv):
        assert torch.equal(got[:, :, :cache_len], orig[:, :, :cache_len])
        assert torch.equal(got[:, :, cache_len + 8:],
                           orig[:, :, cache_len + 8:])


def test_greedy_speculative_frame_on_the_card(cuda_device):
    """One greedy frame at debug scale (full width, one layer a stack; the
    fused int8 decode, bf16 rings) with `speculative_k` = 8 on the card:
    every verify chunk one v5mq launch at Q = 8 (and the three pushes), the
    tokens inside their vocabularies, and against the sequential decode's
    stream: bf16 logits tie often and a Q = 8 verify sums in another order
    than a Q = 1 step, so the streams may part, but every run of differing
    positions starts at a sequential decision whose top-2 logits lie within
    4 bf16 ulps (chip_smoke.py `spec_divergences`, SPEC_GAP_ULPS)."""
    from chip_smoke import SPEC_GAP_ULPS, _GreedyLog, spec_divergences
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import pack_fused
    cfg = ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                      tar_cache_dtype="bfloat16", oar_cache_dtype="int8",
                      fused_oar_kernel=True, tar_cache_window=20
                      ).scaled("debug")
    params = _to(pack_fused(quantize_params_int8(init_params(
        cfg, torch.Generator().manual_seed(3), "cpu"))), cuda_device)
    lo = UMGen(cfg).layout
    cond = make_token_batch(lo, T=2, B=1, seed=0, config=cfg)
    inputs = {m: torch.as_tensor(v, dtype=torch.long, device=cuda_device)
              for m, v in cond.items()}
    log, outs = _GreedyLog(), {}
    for K in (0, 8):
        ro = Rollout(UMGen(cfg.replace(speculative_k=K)))
        if not K:
            ro._samplers = {m: log for m in ro._samplers}
        n0 = tdk.LAUNCHES["fused_decode_step_v5mq"]
        outs[K] = ro.frame_step_prefill(params, inputs,
                                        torch.Generator(cuda_device))[0]
        launched = tdk.LAUNCHES["fused_decode_step_v5mq"] - n0
    spec, seq = outs[8], outs[0]
    assert spec.spec_chunks >= 2196 // 8 and seq.spec_chunks == 0
    assert launched == spec.spec_chunks + 3

    def by_mod(out):
        tok = out.tokens.cpu().numpy()
        return {m: tok[None, :, lo.segment(m).content_start - 1:
                       lo.segment(m).content_end]
                for m in ("map", "bbox3d", "image")}

    mine, ref = by_mod(spec), by_mod(seq)
    for m, V in (("map", 8192), ("bbox3d", 1028), ("image", 8192)):
        assert mine[m].min() >= 0 and mine[m].max() < V
    div = spec_divergences(mine, ref, log.top2, 1, first=0)[1]
    print(div)
    assert div["worst_run_start"] is None \
        or div["worst_run_start"][2] <= SPEC_GAP_ULPS, div


def _vq_pair(cfg, device, seed):
    """One codec's decoder on the card and on the CPU, from the same seeded
    weights (drawn on the CPU)."""
    from umgen_tpu_torch.models import vq
    params = vq.init_normvq(torch.Generator().manual_seed(seed), cfg, "cpu")
    del params["encoder"], params["quant_conv"]
    cls = vq.MapDecoder if cfg == vq.MAP_VQ else vq.ImageDecoder
    return cls(params, device=device), cls(params, device="cpu")


@pytest.mark.parametrize("name", ["map", "image"])
def test_vq_decoders_on_the_card_match_the_cpu(cuda_device, name):
    """The full-width map and image decoders (MAP_VQ, IMAGE_VQ; cuDNN's
    float32 convolutions, TF32 off) on 2 frames in one chunk, against the
    CPU within chip_smoke.py's VQ_ATOL, as phase x."""
    import numpy as np

    from chip_smoke import VQ_ATOL
    from umgen_tpu_torch.models import vq
    cfg, n = {"map": (vq.MAP_VQ, 1024), "image": (vq.IMAGE_VQ, 512)}[name]
    card, cpu = _vq_pair(cfg, cuda_device, seed=0)
    tokens = np.random.default_rng(0).integers(0, 8192, (2, n))
    got, want = card.decode(tokens), cpu.decode(tokens)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= VQ_ATOL
    assert not torch.backends.cudnn.allow_tf32


def test_map_decoder_chunks_on_the_card_as_on_the_cpu(cuda_device):
    """21 frames of the full-width map decoder in its chunks of 20 (the
    last frame normalized alone) on the card and on the CPU: the same
    pictures within VQ_ATOL, and the last frame is its own chunk's."""
    import numpy as np

    from chip_smoke import VQ_ATOL
    from umgen_tpu_torch.models import vq
    card, cpu = _vq_pair(vq.MAP_VQ, cuda_device, seed=1)
    tokens = np.random.default_rng(1).integers(0, 8192, (21, 1024))
    got = card.decode(tokens)
    assert got.shape == (21, 256, 256, 3)
    assert np.abs(got - cpu.decode(tokens)).max() <= VQ_ATOL
    assert np.abs(got[20:] - card.decode(tokens[20:])).max() <= VQ_ATOL
    assert got[20].min() == -1 and got[20].max() == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_collision_helper_matches_numpy(cuda_device, seed):
    """The native helper, built with g++ on the card's host at first use,
    against the numpy version."""
    import numpy as np

    from umgen_tpu_torch import native
    from umgen_tpu_torch.ops.collision import collision_matrix_np
    rng = np.random.default_rng(seed)
    boxes = np.zeros((40, 10), np.float32)
    boxes[:, 0:2] = rng.uniform(-20, 20, (40, 2))
    boxes[:, 3] = rng.uniform(2, 6, 40)
    boxes[:, 4] = rng.uniform(1, 3, 40)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 40)
    got = native.collision_matrix(boxes)
    assert got.any()
    np.testing.assert_array_equal(got, collision_matrix_np(boxes))


# ---------------------------------------------------------------------------
# the exact-erf GELU: bit for bit the plain version run on the card
# ---------------------------------------------------------------------------
def _same_bits(got, ref):
    """Equal bit for bit, a NaN equal to a NaN whatever its payload."""
    bits = torch.int32 if ref.dtype == torch.float32 else torch.int16
    nan = torch.isnan(ref)
    return got.dtype == ref.dtype and torch.equal(torch.isnan(got), nan) \
        and torch.equal(got.view(bits)[~nan], ref.view(bits)[~nan])


def test_gelu_kernel_on_every_bf16_input(cuda_device):
    """All 65 536 bf16 bit patterns (±0, subnormals, ±inf, NaNs) through
    the kernel and through the plain version on the card."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                     device=cuda_device).to(torch.int16).view(torch.bfloat16)
    n0 = tgelu.LAUNCHES["gelu"]
    got = tgelu.gelu(x)
    assert tgelu.LAUNCHES["gelu"] == n0 + 1
    ref = tnn._gelu_plain(x)
    torch.cuda.synchronize()
    assert _same_bits(got, ref)
    # the plain version's NaN at -inf (-inf · erfc(+inf) = -inf · 0)
    special = torch.tensor([float("-inf"), float("inf"), -0.0, 0.0],
                           dtype=torch.bfloat16, device=cuda_device)
    out = tgelu.gelu(special).float().tolist()
    assert math.isnan(out[0]) and out[1] == float("inf")
    assert out[2:] == [0.0, 0.0] and math.copysign(1, out[2]) == -1


def test_gelu_kernel_on_every_fp16_input(cuda_device):
    """All 65 536 fp16 bit patterns through the kernel and the plain
    version on the card."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                     device=cuda_device).to(torch.int16).view(torch.float16)
    assert _same_bits(tgelu.gelu(x), tnn._gelu_plain(x))


def test_gelu_kernel_on_every_float32_input(cuda_device):
    """All 2^32 float32 bit patterns, in chunks of 2^27, through the kernel
    and the plain version on the card (no rounding to x's dtype: erfc and
    0.5·x stay float32)."""
    chunk = 2 ** 27
    for lo in range(-2 ** 31, 2 ** 31, chunk):
        x = torch.arange(lo, lo + chunk, dtype=torch.int64,
                         device=cuda_device).to(torch.int32)
        x = x.view(torch.float32)
        assert _same_bits(tgelu.gelu(x), tnn._gelu_plain(x)), lo


@pytest.mark.parametrize("rows", [22070, 44140])
def test_gelu_kernel_at_the_cells_shapes(cuda_device, rows):
    """[B·S, 3072] activations of the two cells' cascades (10 scenes and
    the 20-frame window at 2207 positions), every branch of erfc taken,
    through `modules.gelu`'s dispatch."""
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    x = (torch.randn(rows, 3072, generator=g, device=cuda_device)
         * 2.5).bfloat16()
    n0 = tgelu.LAUNCHES["gelu"]
    got = tnn.gelu(x)
    assert tgelu.LAUNCHES["gelu"] == n0 + 1
    assert _same_bits(got, tnn._gelu_plain(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 4099, 30725, 2 ** 20 + 3])
def test_gelu_kernel_tails(cuda_device, n, dtype):
    """Lengths that leave elements past the 16-byte vectors (8 bf16, 4
    float32 a vector), and a grid smaller than the cap, and one at it."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = (torch.randn(n, generator=g, device=cuda_device) * 3).to(dtype)
    assert _same_bits(tgelu.gelu(x), tnn._gelu_plain(x))


def test_gelu_views_take_the_kernel(cuda_device):
    """Every CUDA tensor launches the kernel, counted as `gelu.kernel`: a
    strided view, a transposed one, a contiguous one at an unaligned
    offset, fp16 and float32 ones; a gradient-requiring input under
    autograd runs `_GeluFn`, whose forward launches it too, and the kernel
    alone refuses it."""
    from umgen_tpu_torch.runtime import profiler
    x = (torch.randn(64, 3072, device=cuda_device) * 2).bfloat16()
    views = (x, x[:, ::2], x.t(), x.view(-1)[1:], x[:, 1:].half(),
             x.float()[:, 3:])
    n0 = tgelu.LAUNCHES["gelu"]
    profiler.start()
    try:
        for v in views:
            assert _same_bits(tnn.gelu(v), tnn._gelu_plain(v))
        counters = profiler.take()["counters"]
    finally:
        profiler.stop()
    assert tgelu.LAUNCHES["gelu"] == n0 + len(views)
    assert counters == {None: {"gelu.kernel": len(views)}}
    xg = x.clone().requires_grad_(True)
    y = tnn.gelu(xg)
    assert tgelu.LAUNCHES["gelu"] == n0 + len(views) + 1
    assert type(y.grad_fn).__name__ == "_GeluFnBackward"
    with pytest.raises(RuntimeError, match="no backward"):
        tgelu.gelu(xg)
    with pytest.raises(ValueError, match="float64"):
        tnn.gelu(x.double())


# ---------------------------------------------------------------------------
# training: no kernel under autograd, the optimizers and the trainer's step
# on the card against the CPU
# ---------------------------------------------------------------------------
def test_kernels_refuse_autograd_on_the_card(cuda_device):
    """The kernels have no backward: a CUDA input that requires a gradient
    raises before any launch; under no_grad the kernel launches."""
    q = torch.randn(1, 64, 16, 48, device=cuda_device).bfloat16()
    q.requires_grad_(True)
    n0 = tfa.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q, q, q, causal=False)
    assert tfa.LAUNCHES["flash_attention"] == n0
    with torch.no_grad():
        tfa.flash_attention(q, q, q, causal=False)
    assert tfa.LAUNCHES["flash_attention"] == n0 + 1
    x = torch.zeros(1, 1, 768, dtype=torch.bfloat16, device=cuda_device,
                    requires_grad=True)
    kv = torch.zeros(1, 1, 8, 768, dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        tdk.fused_decode_step_v5({}, x, kv, kv, 0, 16)


def _opt_trees(device, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def leaf(*shape, scale, dt=dtype):
        return (torch.randn(*shape, generator=g) * scale).to(dt).to(device)

    def tree(scale):
        return {"tar": {"w": leaf(3, 64, 48, scale=scale),
                        "b": leaf(48, scale=scale)},
                "tpe_rel": leaf(4, 9, scale=scale, dt=torch.float32)}

    return tree(0.02), [tree(s) for s in (0.05, 3.0, 0.01)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_on_the_card_matches_the_cpu(cuda_device, dtype):
    """The trainer's AdamW chain behind the clip (warmup 0: every update
    moves), three updates on the same seeded gradients on both devices:
    the params and the moments within 1e-6 of each leaf's scale (float32:
    the schedule's cos and the bias corrections' pow may differ by an ulp
    between the devices) and within one bf16 ulp of it on bf16 leaves."""
    from umgen_tpu_torch.parallel import optim
    sched = optim.warmup_cosine_decay_schedule(0.0, 3e-4, 0, 10, 3e-5)
    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adamw(sched, weight_decay=0.01))
    out = []
    for dev in ("cpu", cuda_device):
        params, grads = _opt_trees(dev, dtype, seed=0)
        state = tx.init(params)
        for g in grads:
            u, state = tx.update(g, state, params)
            params = optim.apply_updates(params, u)
        out.append((params, state))
    for a, b in zip(optim.tree_leaves(out[0]), optim.tree_leaves(out[1])):
        a, b = a.float(), b.float().cpu()
        scale = max(float(a.abs().max()), 1e-30)
        tol = 2.0 ** -8 if a.dtype == torch.bfloat16 else 1e-6
        assert float((a - b).abs().max()) <= tol * scale


def _tiny_step(device, cfg, params, batch):
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.parallel import optim
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    trainer = UMGenTrainer(UMGen(cfg), learning_rate=3e-4, warmup_steps=1,
                           total_steps=10)
    state = trainer.init_state(optim.tree_map(lambda t: t.to(device),
                                              params))
    state, metrics = trainer.train_step(
        state, {k: v.to(device) for k, v in batch.items()})
    return state, metrics


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One AdamW step of the trainer at the tiny scale in float32 (TF32
    off), card against CPU, with chip_smoke.py phase y's bounds: the loss
    terms and grad_norm, each gradient leaf read from mu = 0.1·g, the
    params after the (warmup) step."""
    import numpy as np

    from chip_smoke import (TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL,
                            TRAIN_PARAM_ATOL)
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.layout import SequenceLayout
    from umgen_tpu_torch.parallel import optim
    from umgen_tpu_torch.params import init_params
    cfg = ModelConfig(use_pallas_attention=False, dtype="float32").scaled(
        "tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    raw = make_token_batch(SequenceLayout(cfg.task), T=3, B=1, seed=0,
                           config=cfg)
    batch = {k: torch.as_tensor(np.asarray(v), dtype=torch.long)
             for k, v in raw.items()}
    card, mcard = _tiny_step(cuda_device, cfg, params, batch)
    cpu, mcpu = _tiny_step("cpu", cfg, params, batch)
    for k, v in mcpu.items():
        assert abs(float(mcard[k]) - float(v)) <= TRAIN_LOSS_RTOL * abs(
            float(v)), k
    gnorm = float(mcpu["grad_norm"])
    for a, b in zip(optim.tree_leaves(cpu.opt_state[1][0]["mu"]),
                    optim.tree_leaves(card.opt_state[1][0]["mu"])):
        b = b.cpu()
        na = float(a.norm())
        if na <= 1e-8 * gnorm:            # zero, or roundoff of a zero
            assert float(b.norm()) <= 1e-8 * gnorm
        else:
            assert float((b - a).norm()) <= TRAIN_GRAD_RTOL * na
    for a, b in zip(optim.tree_leaves(cpu.params),
                    optim.tree_leaves(card.params)):
        assert float((b.detach().cpu() - a.detach()).abs().max()) <= \
            TRAIN_PARAM_ATOL


def test_train_steps_are_deterministic_on_the_card(cuda_device):
    """Two runs of the same step from the same state give the same bits
    (the trained tables' and the map warp's gradients are scatter-adds
    by F.embedding, deterministic on the card; chip_smoke.py phase y's
    checkpoint round trip relies on it)."""
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.layout import SequenceLayout
    from umgen_tpu_torch.parallel import optim
    from umgen_tpu_torch.params import init_params
    cfg = ModelConfig(use_pallas_attention=False).scaled("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    raw = make_token_batch(SequenceLayout(cfg.task), T=3, B=1, seed=1,
                           config=cfg)
    batch = {k: torch.as_tensor(v, dtype=torch.long) for k, v in raw.items()}
    a, _ = _tiny_step(cuda_device, cfg, params, batch)
    b, _ = _tiny_step(cuda_device, cfg, params, batch)
    for x, y in zip(optim.tree_leaves((a.params, a.opt_state)),
                    optim.tree_leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)
