"""Parameter bridge: the JAX package's params pytree ↔ the port's.

The port keeps the JAX tree as it is — nested dicts (and the VQ tree's
lists) with the same names,
shapes and dtypes, stacked layers along a leading L axis, linear leaves
{"w", "b"} or the int8 {"wq", "ws", "b"} of runtime/quantize — with torch
tensors as leaves.  `from_jax` converts a tree that came from the JAX
package (numpy or jax arrays); `init_params` builds a tree of the same names
and shapes directly on a device, from a torch.Generator, for machines
without JAX (the values differ from the JAX initializer's; the shapes,
dtypes and structure do not).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from umgen_tpu_torch.config import ModelConfig
from umgen_tpu_torch.layout import SequenceLayout

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
           "int8": torch.int8}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def to_tensor(a, device=None) -> torch.Tensor:
    """One array leaf (numpy, ml_dtypes bfloat16 or jax) → torch tensor of
    the same dtype."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":      # the bytes, as they are
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device) if device is not None else t


def from_jax(tree: Params, device=None) -> Params:
    """The JAX params pytree (numpy/jax leaves; dict and list nodes, as the
    VQ tree's `up` / `block` lists) → the port's params."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_jax(v, device) for v in tree]
    return to_tensor(tree, device)


# ---------------------------------------------------------------------------
# on-device initialization (UMGen.init_params's names and shapes)
# ---------------------------------------------------------------------------
class _Init:
    """`bias`: the config's flag — attention projections carry biases
    without it (`bias=not config.bias`), the stacks' MLPs with it."""

    def __init__(self, generator: torch.Generator, device, dtype,
                 bias: bool = False):
        self.g, self.device, self.dtype = generator, device, dtype
        self.bias = bias

    def normal(self, *shape) -> torch.Tensor:
        w = torch.randn(*shape, generator=self.g, device=self.device,
                        dtype=torch.float32)
        return (w * 0.02).to(self.dtype)

    def linear(self, d_in, d_out, bias: bool, L=None) -> Params:
        lead = () if L is None else (L,)
        p = {"w": self.normal(*lead, d_in, d_out)}
        if bias:
            p["b"] = torch.zeros(*lead, d_out, device=self.device,
                                 dtype=self.dtype)
        return p

    def ln(self, d, L=None) -> Params:
        lead = () if L is None else (L,)
        return {"w": torch.ones(*lead, d, device=self.device,
                                dtype=self.dtype)}

    def attn(self, d, L) -> Params:
        return {"qkv": self.linear(d, 3 * d, not self.bias, L),
                "proj": self.linear(d, d, not self.bias, L)}

    def mlp(self, d, L=None, d_hidden=None, d_out=None,
            bias: Optional[bool] = None) -> Params:
        d_hidden = d_hidden or 4 * d
        bias = self.bias if bias is None else bias
        return {"fc": self.linear(d, d_hidden, bias, L),
                "proj": self.linear(d_hidden, d_out or d, bias, L)}

    def block_tar(self, d, L) -> Params:
        return {"ln1": self.ln(d, L), "sa1": self.attn(d, L),
                "ln2": self.ln(d, L), "mlp1": self.mlp(d, L),
                "ln3": self.ln(d, L), "ta": self.attn(d, L),
                "ln4": self.ln(d, L), "mlp2": self.mlp(d, L),
                "ln5": self.ln(d, L), "sa2": self.attn(d, L),
                "ln6": self.ln(d, L), "mlp3": self.mlp(d, L)}

    def block_oar(self, d, L) -> Params:
        return {"ln1": self.ln(d, L), "attn": self.attn(d, L),
                "ln2": self.ln(d, L), "mlp": self.mlp(d, L)}

    def decoder_block(self, d, L) -> Params:
        cross = {n: self.linear(d, d, not self.bias, L)
                 for n in ("q", "k", "v", "proj")}
        return {"ln1": self.ln(d, L), "self_attn": self.attn(d, L),
                "ln2": self.ln(d, L), "ln3": self.ln(d, L),
                "cross_attn": cross, "ln4": self.ln(d, L),
                "mlp": self.mlp(d, L)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                buffers: Optional[Params] = None) -> Params:
    """Random-init params with UMGen.init_params's names and shapes, built
    on `device` (weights N(0, 0.02), layer norms 1, biases 0).  n_step > 1
    replaces head_tar_bbox3d with the n-step head [d, n_step·V]."""
    from umgen_tpu_torch.models.umgen import build_buffers
    d = cfg.n_embd
    ini = _Init(generator, device, torch_dtype(cfg.dtype), cfg.bias)
    layout = SequenceLayout(cfg.task)
    params: Params = {
        "egoe": ini.normal(3, d),
        "axe": ini.normal(cfg.aux_vocab_size, d),
        "be": ini.normal(cfg.bbox3d_vocab_size, d),
        "tpe": ini.normal(cfg.max_frame_len, d),
        "tpe_rel": torch.zeros(cfg.n_head, cfg.max_frame_len,
                               device=device, dtype=torch.float32),
        "spe": ini.normal(layout.seq_len, d),
        "tske": ini.normal(7, d),
        "map_mlp_pre": ini.mlp(cfg.n_map_embd, d_hidden=4 * d, d_out=d,
                               bias=False),
        "tar": ini.block_tar(d, cfg.n_tar_layer),
        "ln_tar": ini.ln(d),
        "oar": ini.block_oar(d, cfg.n_oar_layer),
        "ln_oar": ini.ln(d),
        "ego_tar": ini.block_tar(d, cfg.n_ego_tar_layer),
        "ln_ego_tar": ini.ln(d),
        "ego_ca": ini.decoder_block(d, cfg.n_ego_ca_layer),
        "ln_ego": ini.ln(d),
        "head_tar_aux": ini.linear(d, cfg.aux_vocab_size, False),
        "head_tar_pose": ini.linear(d, cfg.pose_vocab_size, False),
        "head_tar_map": ini.linear(d, cfg.map_vocab_size, False),
        "head_tar_bbox3d": ini.linear(d, cfg.bbox3d_vocab_size, False),
        "head_ar_aux": ini.linear(d, cfg.aux_vocab_size, False),
        "head_ar_pose": ini.linear(d, cfg.pose_vocab_size, False),
        "head_ar_map": ini.linear(d, cfg.map_vocab_size, False),
        "head_ar_bbox3d": ini.linear(d, cfg.bbox3d_vocab_size, False),
        "head_ego": ini.linear(d, cfg.pose_vocab_size, False),
    }
    if cfg.n_step > 1:
        del params["head_tar_bbox3d"]
        params["head_tar_n_step_bbox3d"] = ini.linear(
            d, cfg.bbox3d_vocab_size * cfg.n_step, False)
    if cfg.split_map_tar:
        params["map_tar"] = ini.block_tar(d, cfg.n_map_tar_layer)
        params["ln_map_tar"] = ini.ln(d)
    if cfg.sample_img:
        params["head_tar_img"] = ini.linear(d, cfg.img_vocab_size, False)
        params["head_ar_img"] = ini.linear(d, cfg.img_vocab_size, False)
        params["img_mlp_pre"] = ini.mlp(cfg.n_img_embd, d_hidden=4 * d,
                                        d_out=d, bias=False)
    if cfg.split_box_tar and "bbox3d" in layout.mod_order:
        params["box_tar"] = ini.block_tar(d, cfg.n_box_tar_layer)
        params["ln_box_tar"] = ini.ln(d)
    params["buffers"] = (buffers if buffers is not None
                         else build_buffers(cfg, device=device))
    return params
