"""The port's VQ codecs (umgen_tpu_torch/models/vq.py) against the JAX
package's, on the CPU, at small widths.

The same params (umgen_tpu.models.vq.init_normvq(PRNGKey(0), ...), carried
across by params.from_jax) and the same inputs go through both packages.
Two tiny configs keep the full codebook of 8192 rows (the CLI's tokens index
it) and the decoders' token grids: a map-like one (a 1×1 post-quant conv,
attention at the mid block only) and an image-like one (a 3×3 post-quant
conv, attention in every block of its first up level).  Tolerances:
`decode_code` / `decoder_forward` within 2e-4 absolute, the bound
tests/test_vq.py holds JAX to against the reference (float32 convolutions
summed in other orders; first reading ~5e-6); `encode_to_indices` equal on
>= 99% of the codes (nearest-code ties, as tests/test_vq.py); FSQ, the to_rgb
table and the importer bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgen_tpu.models import vq as jvq
from umgen_tpu.runtime import torch_import as jti
from umgen_tpu_torch.models import vq as tvq
from umgen_tpu_torch.params import from_jax
from umgen_tpu_torch.runtime import torch_import as tti

ATOL = 2e-4

TINY_MAP = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
                num_res_blocks=1, attn_resolutions=(), resolution=64)
TINY_IMAGE = dict(embed_dim=8, z_channels=8, ch=32, ch_mult=(1, 2),
                  num_res_blocks=1, attn_resolutions=(32,), in_channels=3,
                  out_ch=3, resolution=64, post_quant_kernel=3)
CONFIGS = {"map": (TINY_MAP, (32, 32)), "image": (TINY_IMAGE, (16, 32))}


def configs(name):
    """(the JAX config, the port's config, the token grid)."""
    fields, grid = CONFIGS[name]
    return jvq.VQConfig(**fields), tvq.VQConfig(**fields), grid


def patch_tiny(monkeypatch):
    """Both packages' MAP_VQ / IMAGE_VQ → the tiny configs (the decoder
    classes read them when they are built)."""
    for mod, cls in ((jvq, jvq.VQConfig), (tvq, tvq.VQConfig)):
        monkeypatch.setattr(mod, "MAP_VQ", cls(**TINY_MAP))
        monkeypatch.setattr(mod, "IMAGE_VQ", cls(**TINY_IMAGE))


def jax_params(name, seed=0):
    return jvq.init_normvq(jax.random.PRNGKey(seed), configs(name)[0])


def reference_state_dict(tree):
    """A JAX VQ tree → the reference NormVQModel's state dict (the names
    `import_vq` reads; conv weights HWIO → OIHW)."""
    sd = {}

    def put(prefix, node):
        if isinstance(node, list):
            for i, v in enumerate(node):
                put(f"{prefix}.{i}", v)
        elif "w" in node:                       # a conv or a group norm
            w = np.asarray(node["w"])
            sd[f"{prefix}.weight"] = torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                if w.ndim == 4 else w.copy())
            sd[f"{prefix}.bias"] = torch.from_numpy(np.array(node["b"]))
        else:
            for k, v in node.items():
                put(f"{prefix}.{k}", v)

    for k, v in tree.items():
        if k == "codebook":
            sd["quantize.embedding.weight"] = torch.from_numpy(
                np.asarray(v).copy())
        else:
            put(k, v)
    return sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_same_tree(port, jax_tree):
    """Leaf for leaf: the same paths, shapes, dtypes and values."""
    a, b = dict(_leaves(port)), dict(_leaves(jax_tree))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), k)


@pytest.mark.parametrize("name", ["map", "image"])
def test_decode_code_matches_jax(name):
    jc, tc, grid = configs(name)
    p = jax_params(name)
    idx = np.random.default_rng(0).integers(0, jc.n_embed, (3, *grid))
    want = np.asarray(jvq.decode_code(p, jc, jnp.asarray(idx)))
    got = tvq.decode_code(tvq.oihw(from_jax(p)), tc, torch.as_tensor(idx))
    assert got.shape == want.shape == (3, 2 * grid[0], 2 * grid[1],
                                       jc.out_ch)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["map", "image"])
def test_decoder_forward_matches_jax(name):
    jc, tc, grid = configs(name)
    p = jax_params(name, seed=1)
    z = np.random.default_rng(1).normal(
        size=(2, *grid, jc.z_channels)).astype(np.float32)
    want = np.asarray(jvq.decoder_forward(p["decoder"], jc, jnp.asarray(z)))
    got = tvq.decoder_forward(tvq.oihw(from_jax(p["decoder"])), tc,
                              torch.as_tensor(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["map", "image"])
def test_encode_to_indices_agrees_with_jax(name):
    jc, tc, _ = configs(name)
    p = jax_params(name)
    x = np.random.default_rng(2).normal(
        size=(2, 64, 64, jc.in_channels)).astype(np.float32)
    want = np.asarray(jvq.encode_to_indices(p, jc, jnp.asarray(x)))
    got = tvq.encode_to_indices(tvq.oihw(from_jax(p)), tc,
                                torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 32, 32)
    assert (got == want).mean() >= 0.99


def test_fsq_bit_for_bit():
    levels = [8, 5, 5, 5]
    j, t = jvq.FSQ(levels), tvq.FSQ(levels)
    assert t.n_codes == j.n_codes == 1000
    z = (np.random.default_rng(3).normal(size=(4000, 4)) * 2).astype(
        np.float32)
    q = t.quantize(torch.as_tensor(z)).numpy()
    np.testing.assert_array_equal(q, np.asarray(j.quantize(jnp.asarray(z))))
    np.testing.assert_array_equal(
        t.codes_to_indices(torch.as_tensor(q)).numpy(),
        np.asarray(j.codes_to_indices(jnp.asarray(q))))
    idx = np.arange(1000)
    np.testing.assert_array_equal(
        t.indices_to_codes(torch.as_tensor(idx)).numpy(),
        np.asarray(j.indices_to_codes(jnp.asarray(idx))))
    # the codes round-trip through their indices
    np.testing.assert_array_equal(
        t.codes_to_indices(t.indices_to_codes(torch.as_tensor(idx))).numpy(),
        idx)


def test_to_rgb_table_is_jaxs_draw():
    """The port's literal projection equals JAX's PRNGKey(0) draw, and
    to_rgb (the whole chunk's min and max) gives JAX's pictures."""
    draw = jax.random.normal(jax.random.PRNGKey(0), (1, 1, 5, 3),
                             jnp.float32)
    np.testing.assert_array_equal(np.array(tvq.TO_RGB_W, np.float32),
                                  np.asarray(draw)[0, 0])
    x = np.random.default_rng(4).normal(size=(3, 8, 8, 5)).astype(
        np.float32)
    np.testing.assert_allclose(tvq.to_rgb(torch.as_tensor(x)).numpy(),
                               np.asarray(jvq.to_rgb(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def test_map_decoder_matches_jax_chunk_for_chunk(monkeypatch):
    """21 frames in chunks of 20: the last frame is normalized alone, in
    both packages."""
    patch_tiny(monkeypatch)
    p = jax_params("map")
    tokens = np.random.default_rng(5).integers(0, 8192, (21, 1024))
    want = jvq.MapDecoder(p).decode(tokens)
    dec = tvq.MapDecoder(from_jax(p), device="cpu")
    got = dec.decode(tokens)
    assert got.shape == want.shape == (21, 64, 64, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[20:], dec.decode(tokens[20:]))
    assert got.min() >= -1 and got.max() <= 1
    assert not np.allclose(got[20:], dec.decode(tokens, chunk=21)[20:],
                           atol=1e-2)


def test_image_decoder_matches_jax(monkeypatch):
    patch_tiny(monkeypatch)
    p = jax_params("image")
    tokens = np.random.default_rng(6).integers(0, 8192, (3, 512))
    want = jvq.ImageDecoder(p).decode(tokens)
    got = tvq.ImageDecoder(from_jax(p), device="cpu").decode(tokens)
    assert got.shape == want.shape == (3, 32, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_tokenizer_roundtrip_matches_jax():
    jc, tc, _ = configs("image")
    p = jax_params("image")
    x = np.random.default_rng(7).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = jvq.NormVQTokenizer(jc, p).encode(x)
    tok = tvq.NormVQTokenizer(tc, from_jax(p), device="cpu")
    assert (tok.encode(x) == want).mean() >= 0.99
    np.testing.assert_allclose(tok.decode(want), np.asarray(
        jvq.decode_code(p, jc, jnp.asarray(want))), rtol=0, atol=ATOL)
    assert tok.roundtrip(x).shape == x.shape


@pytest.mark.parametrize("name", ["map", "image"])
def test_init_normvq_builds_jaxs_tree(name):
    """On a torch.Generator: the JAX initializer's names, list lengths,
    shapes and dtypes (HWIO conv weights), unit-norm codebook rows."""
    jc, tc, _ = configs(name)
    port = tvq.init_normvq(torch.Generator().manual_seed(0), tc, "cpu")
    a, b = dict(_leaves(port)), dict(_leaves(jax_params(name)))
    assert sorted(a) == sorted(b)
    for k in a:
        assert tuple(a[k].shape) == b[k].shape and \
            a[k].dtype == torch.float32, k
    torch.testing.assert_close(port["codebook"].norm(dim=-1),
                               torch.ones(jc.n_embed))
    again = tvq.init_normvq(torch.Generator().manual_seed(0), tc, "cpu")
    assert all(torch.equal(v, dict(_leaves(again))[k]) for k, v in a.items())


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "wrapped"])
@pytest.mark.parametrize("name", ["map", "image"])
def test_vq_importer_matches_jax(tmp_path, name, wrapped):
    """A reference-format state dict (with or without its {"state_dict":
    ...} wrapper) through both packages' load_vq_checkpoint: JAX's tree
    leaf for leaf; without the encoder, the decoder half only."""
    jc, tc, _ = configs(name)
    sd = reference_state_dict(jax_params(name, seed=2))
    path = str(tmp_path / "vq.ckpt")
    torch.save({"state_dict": sd} if wrapped else sd, path)
    assert_same_tree(tti.load_vq_checkpoint(path, tc),
                     jti.load_vq_checkpoint(path, jc))
    dec_only = {k: v for k, v in sd.items()
                if not k.startswith(("encoder.", "quant_conv."))}
    got = tti.import_vq(dec_only, tc)
    assert "encoder" not in got and "quant_conv" not in got
    assert_same_tree(got, jti.import_vq(dec_only, jc))


def test_from_jax_takes_list_nodes():
    tree = {"up": [{"block": [np.ones((1, 1, 2, 3), np.float32)],
                    "attn": []}], "b": np.zeros(2, np.int32)}
    got = from_jax(tree)
    assert isinstance(got["up"], list) and got["up"][0]["attn"] == []
    assert got["up"][0]["block"][0].shape == (1, 1, 2, 3)
    assert got["b"].dtype == torch.int32


def test_group_norm_uses_the_references_eps():
    """eps 1e-6 (torch's default 1e-5 differs visibly on a small-variance
    group)."""
    x = np.random.default_rng(8).normal(size=(1, 4, 4, 32)).astype(
        np.float32) * 1e-3
    p = {"w": np.ones(32, np.float32), "b": np.zeros(32, np.float32)}
    want = np.asarray(jvq.group_norm(p, jnp.asarray(x)))
    got = tvq.group_norm(from_jax(p), torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4)
