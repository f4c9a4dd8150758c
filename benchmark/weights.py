"""Seeded weights of a configuration, made on the device by the benchmark.

Both sides are handed the same tree: the program quantizes and packs it in
its set-up, the reference works its own weights out of it again.  The
tree has the names and shapes of the program's parameter tree (stacked
layers on a leading axis, linear leaves {"w" [in, out], "b"}, layer norms
{"w"}), with the published initialisation's law: weights N(0, 0.02), layer
norms 1, biases 0.  Every normal leaf is a view of one flat buffer filled
in a few large `torch.randn` calls on the card, in the activation dtype (one buffer a top-level key).

The frozen tables under "buffers" follow the model's definition: the
sinusoid PEs rounded through bf16, the map grid's centre PE, seeded VQ
codebooks, and the pose and agent bin tables.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 28          # elements a randn call

Tree = Dict


def _spec(m: Dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, law) of every leaf: law "normal", "ones" or "zeros"."""
    d, out = m["n_embd"], []
    bias_attn = not m["bias"]

    def lin(path, din, dout, bias, L=None):
        lead = () if L is None else (L,)
        out.append((path + ".w", lead + (din, dout), "normal"))
        if bias:
            out.append((path + ".b", lead + (dout,), "zeros"))

    def ln(path, L=None):
        out.append((path + ".w", (() if L is None else (L,)) + (d,), "ones"))

    def attn(path, L):
        lin(path + ".qkv", d, 3 * d, bias_attn, L)
        lin(path + ".proj", d, d, bias_attn, L)

    def mlp(path, din, L=None, bias=None):
        bias = m["bias"] if bias is None else bias
        lin(path + ".fc", din, 4 * d, bias, L)
        lin(path + ".proj", 4 * d, d, bias, L)

    def block_tar(path, L):
        for i, sub in ((1, "sa1"), (3, "ta"), (5, "sa2")):
            ln(f"{path}.ln{i}", L)
            attn(f"{path}.{sub}", L)
            ln(f"{path}.ln{i + 1}", L)
            mlp(f"{path}.mlp{(i + 1) // 2}", d, L)

    seq = sum(n + 2 for _, n, _, _ in m["layout"])
    for name, shape in (("egoe", (3, d)), ("axe", (m["aux_vocab_size"], d)),
                        ("be", (m["bbox3d_vocab_size"], d)),
                        ("tpe", (m["max_frame_len"], d)), ("spe", (seq, d)),
                        ("tske", (7, d))):
        out.append((name, shape, "normal"))
    mlp("map_mlp_pre", m["n_map_embd"], bias=False)
    mlp("img_mlp_pre", m["n_img_embd"], bias=False)
    for stack, key in (("tar", "n_tar_layer"), ("ego_tar", "n_ego_tar_layer"),
                       ("map_tar", "n_map_tar_layer"),
                       ("box_tar", "n_box_tar_layer")):
        block_tar(stack, m[key])
        ln("ln_" + stack)
    L = m["n_oar_layer"]
    ln("oar.ln1", L)
    attn("oar.attn", L)
    ln("oar.ln2", L)
    mlp("oar.mlp", d, L)
    ln("ln_oar")
    L = m["n_ego_ca_layer"]
    ln("ego_ca.ln1", L)
    attn("ego_ca.self_attn", L)
    ln("ego_ca.ln2", L)
    ln("ego_ca.ln3", L)
    for n in ("q", "k", "v", "proj"):
        lin(f"ego_ca.cross_attn.{n}", d, d, bias_attn, L)
    ln("ego_ca.ln4", L)
    mlp("ego_ca.mlp", d, L)
    ln("ln_ego")
    vocab = {"aux": m["aux_vocab_size"], "pose": m["pose_vocab_size"],
             "map": m["map_vocab_size"], "bbox3d": m["bbox3d_vocab_size"],
             "img": m["img_vocab_size"]}
    for kind in ("tar", "ar"):
        for v, n in vocab.items():
            lin(f"head_{kind}_{v}", d, n, False)
    lin("head_ego", d, m["pose_vocab_size"], False)
    return out


def _put(tree: Tree, path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def sinusoid(n_position: int, emb_dim: int, start_index: int = 0
             ) -> np.ndarray:
    """Sinusoid table [n_position, emb_dim] float32 with a zero row 0."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(emb_dim, dtype=np.float64)[None, :]
    table = (pos + start_index) / np.power(10000.0, 2 * (j // 2) / emb_dim)
    table[0, :] = 0.0
    table[1:, 0::2] = np.sin(table[1:, 0::2])
    table[1:, 1::2] = np.cos(table[1:, 1::2])
    return table.astype(np.float32)


def _bin_mid(lo: float, hi: float, n: int) -> np.ndarray:
    """Midpoint of each of n token ids over n bin edges linspace(lo, hi)."""
    bins = np.linspace(lo, hi, n)
    ids = np.arange(n)
    return ((bins[np.clip(ids - 1, 0, n - 1)] + bins[np.clip(ids, 0, n - 1)])
            / 2).astype(np.float32)


# agent attribute ranges: x, y, z, l, w, h, yaw, vx, vy, vz
AGENT_RANGE = ((-64.0, 64.0), (-64.0, 64.0), (-5.0, 5.0), (0.0, 15.0),
               (0.0, 4.0), (0.0, 5.0), (-3.14, 3.14), (-20.0, 20.0),
               (-15.0, 15.0), (-0.3, 0.3))


def buffers(m: Dict, generator: torch.Generator, device, dtype) -> Tree:
    """The frozen tables: PEs, the map grid PE, codebooks, bin tables."""
    d = m["n_embd"]

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    fouier = bf16(sinusoid(1024, d))
    spatial = bf16(sinusoid(1030, d, start_index=1024))
    gh = 32
    cell = 128.0 / gh
    gi, gj = np.meshgrid(np.arange(gh), np.arange(gh), indexing="ij")
    cx = -((gi + 0.5) * cell - 64.0)
    cy = -((gj + 0.5) * cell - 64.0)
    norm = (np.stack([cx, cy], axis=-1) + 64.0) / 128.0
    tok = np.digitize(norm, np.linspace(0.0, 1.0, 1024))
    grid = spatial[tok[..., 0].reshape(-1)] + spatial[tok[..., 1].reshape(-1)]

    def t(a, dt):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dt)

    lo = np.array([r[0] for r in AGENT_RANGE], np.float32)
    hi = np.array([r[1] for r in AGENT_RANGE], np.float32)
    books = torch.randn(m["map_vocab_size"] + m["img_vocab_size"],
                        m["n_map_embd"], generator=generator, device=device)
    return {
        "fouier_pe": t(fouier, dtype), "bbox_spatial_pe": t(spatial, dtype),
        "grid_center_pe": t(grid, dtype),
        "map_codebook": books[:m["map_vocab_size"]].to(dtype),
        "img_codebook": books[m["map_vocab_size"]:].to(dtype),
        "ego_bin_mid": t(_bin_mid(-1.0, 1.0, 1024), torch.float32),
        "ego_mean": t(np.zeros(3, np.float32), torch.float32),
        "ego_std": t(np.array([10.0, 4.0, 1.0], np.float32), torch.float32),
        "agent_bin_mid": t(_bin_mid(0.0, 1.0, 1024), torch.float32),
        "agent_lo": t(lo, torch.float32),
        "agent_span": t(hi - lo, torch.float32),
    }


def make_weights(m: Dict, seed: int, device) -> Tree:
    """The configuration's raw weight tree from `seed`, on `device`."""
    dtype = {"bfloat16": torch.bfloat16,
             "float32": torch.float32}[m["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    spec = _spec(m)
    # one buffer a top-level key, so that a leaf the program keeps holds
    # its own subtree's memory and no other
    groups: Dict[str, int] = {}
    for path, shape, law in spec:
        if law == "normal":
            top = path.split(".")[0]
            groups[top] = groups.get(top, 0) + math.prod(shape)
    flats = {}
    for top, n_normal in groups.items():
        flat = torch.empty(n_normal, dtype=dtype, device=device)
        for lo in range(0, n_normal, CHUNK):
            n = min(CHUNK, n_normal - lo)
            flat[lo:lo + n] = (torch.randn(n, generator=g, device=device)
                               * 0.02).to(dtype)
        flats[top] = [flat, 0]
    tree: Tree = {}
    for path, shape, law in spec:
        if law == "normal":
            n = math.prod(shape)
            flat = flats[path.split(".")[0]]
            leaf = flat[0][flat[1]:flat[1] + n].view(shape)
            flat[1] += n
        elif law == "ones":
            leaf = torch.ones(shape, dtype=dtype, device=device)
        else:
            leaf = torch.zeros(shape, dtype=dtype, device=device)
        _put(tree, path, leaf)
    tree["tpe_rel"] = torch.zeros(m["n_head"], m["max_frame_len"],
                                  device=device)
    tree["buffers"] = buffers(m, g, device, dtype)
    return tree
