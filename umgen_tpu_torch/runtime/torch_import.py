"""The reference checkpoint → the port's params (port of the UMGen half of
umgen_tpu/runtime/torch_import.py).

`UMGen_Large.pt` is a DeepSpeed-format state dict (the reference loads
checkpoint["model_state"]["module"], ref:projects/tools/infer_fun.py:43-50;
names from ref:UMGen.py:176-245).  `import_umgen` maps it straight onto the
port's tree (`params.py`: the JAX package's names, shapes and dtypes, layers
stacked along L): torch's [out, in] linear weights transpose to [in, out];
the attention projections carry biases and the MLPs do not (the reference's
quirk), and whatever biases the state dict holds come along.

`import_vq` maps the VQGAN checkpoints (`map_vae.ckpt`, `image_vae.tar`:
the reference's NormVQModel, ref:vq_model.py:65-78) onto the VQ tree of
models/vq.py: conv weights OIHW → HWIO (the JAX tree's layout; the codecs
turn them back once when they are built), the 1×1 attention convs kept as
convs, `quantize.embedding.weight` → the codebook.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from umgen_tpu_torch.models.umgen import NotPortedError, build_buffers
from umgen_tpu_torch.params import torch_dtype

Params = Dict[str, Any]


class _Reader:
    """Reads the state dict's tensors in `dtype` on `device`."""

    def __init__(self, sd: Dict[str, Any], device, dtype):
        self.sd, self.device, self.dtype = sd, device, dtype

    def t(self, name: str) -> torch.Tensor:
        return self.sd[name].detach().to(device=self.device,
                                          dtype=self.dtype)

    def linear(self, name: str) -> Params:
        p = {"w": self.t(f"{name}.weight").t().contiguous()}
        if f"{name}.bias" in self.sd:
            p["b"] = self.t(f"{name}.bias")
        return p

    def ln(self, name: str) -> Params:
        return {"w": self.t(f"{name}.weight")}

    def attn(self, name: str) -> Params:
        return {"qkv": self.linear(f"{name}.c_attn"),
                "proj": self.linear(f"{name}.c_proj")}

    def mlp(self, name: str) -> Params:
        return {"fc": self.linear(f"{name}.c_fc"),
                "proj": self.linear(f"{name}.c_proj")}

    def block_tar(self, name: str) -> Params:
        return {"ln1": self.ln(f"{name}.ln_1"),
                "sa1": self.attn(f"{name}.spatial_attn_1"),
                "ln2": self.ln(f"{name}.ln_2"),
                "mlp1": self.mlp(f"{name}.mlp1"),
                "ln3": self.ln(f"{name}.ln_3"),
                "ta": self.attn(f"{name}.temporal_attn"),
                "ln4": self.ln(f"{name}.ln_4"),
                "mlp2": self.mlp(f"{name}.mlp2"),
                "ln5": self.ln(f"{name}.ln_5"),
                "sa2": self.attn(f"{name}.spatial_attn_2"),
                "ln6": self.ln(f"{name}.ln_6"),
                "mlp3": self.mlp(f"{name}.mlp3")}

    def block_oar(self, name: str) -> Params:
        return {"ln1": self.ln(f"{name}.ln_1"),
                "attn": self.attn(f"{name}.temporal_attn"),
                "ln2": self.ln(f"{name}.ln_2"),
                "mlp": self.mlp(f"{name}.mlp")}

    def decoder_block(self, name: str) -> Params:
        # FlashCrossAttention names its projections q/k/v_attn (what trained
        # checkpoints carry); the manual CrossAttention q/k/v_attn_wp
        # (ref:module.py:459-471,525-533)
        ca = f"{name}.cross_attn"
        sfx = "" if f"{ca}.q_attn.weight" in self.sd else "_wp"
        return {"ln1": self.ln(f"{name}.ln_1"),
                "self_attn": self.attn(f"{name}.self_attn"),
                "ln2": self.ln(f"{name}.ln_2"),
                "ln3": self.ln(f"{name}.ln_3"),
                "cross_attn": {"q": self.linear(f"{ca}.q_attn{sfx}"),
                               "k": self.linear(f"{ca}.k_attn{sfx}"),
                               "v": self.linear(f"{ca}.v_attn{sfx}"),
                               "proj": self.linear(f"{ca}.c_proj")},
                "ln4": self.ln(f"{name}.ln_4"),
                "mlp": self.mlp(f"{name}.mlp1")}

    def stack(self, block, name: str, n: int) -> Params:
        layers = [getattr(self, block)(f"{name}.{i}") for i in range(n)]
        return _stack(layers)


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lay[k] for lay in layers]) for k in layers[0]}
    return torch.stack(layers)


def extract_state_dict(checkpoint) -> Dict[str, Any]:
    """Unwrap the DeepSpeed container (ref:infer_fun.py:43-50)."""
    if "model_state" in checkpoint:
        checkpoint = checkpoint["model_state"]
    if "module" in checkpoint:
        checkpoint = checkpoint["module"]
    return checkpoint


def import_umgen(state_dict: Dict[str, Any], config, device="cpu",
                 dtype=torch.float32) -> Params:
    """Reference state dict → the port's params (leaves in `dtype` on
    `device`, buffers excluded).  The JAX package's import is float32, and
    its loader casts that to the config's dtype; reading straight into it
    gives the same values (a float32 step between the checkpoint's floating
    type and the target is exact) without the float32 copy."""
    tr = "transformer"
    if config.n_step != 1 or f"{tr}.head_tar_n_step_bbox3d.weight" in \
            state_dict:
        raise NotPortedError("the n-step bbox TAR head "
                             "(head_tar_n_step_bbox3d) is not ported yet "
                             "(ROADMAP.md: 'Smaller configuration items')")
    r = _Reader(state_dict, device, dtype)
    params: Params = {
        "egoe": r.t(f"{tr}.egoe.weight"),
        "axe": r.t(f"{tr}.axe.weight"),
        "be": r.t(f"{tr}.be.weight"),
        "tpe": r.t(f"{tr}.tpe.weight"),
        # the reference has no relative temporal-PE table: the neutral one,
        # as the initializer builds it (absolute mode never reads it)
        "tpe_rel": torch.zeros(config.n_head, config.max_frame_len,
                               device=device, dtype=dtype),
        "spe": r.t(f"{tr}.spe.weight"),
        "tske": r.t(f"{tr}.tske.weight"),
        "map_mlp_pre": r.mlp("map_mlp_pre"),
        "ln_tar": r.ln(f"{tr}.ln_tar"),
        "ln_oar": r.ln(f"{tr}.ln_oar"),
        "ln_ego_tar": r.ln(f"{tr}.ln_ego_tar"),
        "ln_ego": r.ln(f"{tr}.ln_ego"),
        "tar": r.stack("block_tar", f"{tr}.TAR", config.n_tar_layer),
        "oar": r.stack("block_oar", f"{tr}.OAR", config.n_oar_layer),
        "ego_tar": r.stack("block_tar", f"{tr}.ego_tar",
                           config.n_ego_tar_layer),
        "ego_ca": r.stack("decoder_block", f"{tr}.ego_cross_attn",
                          config.n_ego_ca_layer),
        "head_tar_aux": r.linear(f"{tr}.head_tar_aux"),
        "head_tar_pose": r.linear(f"{tr}.head_tar_pose"),
        "head_tar_map": r.linear(f"{tr}.head_tar_map"),
        "head_ar_aux": r.linear(f"{tr}.head_ar_aux"),
        "head_ar_pose": r.linear(f"{tr}.head_ar_pose"),
        "head_ar_map": r.linear(f"{tr}.head_ar_map"),
        "head_ar_bbox3d": r.linear(f"{tr}.head_ar_bbox3d"),
        "head_ego": r.linear(f"{tr}.head_ego"),
        "head_tar_bbox3d": r.linear(f"{tr}.head_tar_bbox3d"),
    }
    if config.split_map_tar:
        params["map_tar"] = r.stack("block_tar", f"{tr}.map_tar",
                                    config.n_map_tar_layer)
        params["ln_map_tar"] = r.ln(f"{tr}.ln_map_tar")
    if config.sample_img:
        params["head_tar_img"] = r.linear(f"{tr}.head_tar_img")
        params["head_ar_img"] = r.linear(f"{tr}.head_ar_img")
        params["img_mlp_pre"] = r.mlp("img_mlp_pre")
        if config.split_box_tar:
            params["box_tar"] = r.stack("block_tar", f"{tr}.box_tar",
                                        config.n_box_tar_layer)
            params["ln_box_tar"] = r.ln(f"{tr}.ln_box_tar")
    return params


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def load_umgen_checkpoint(path: str, config, pipeline=None,
                          map_codebook_path: Optional[str] = None,
                          img_codebook_path: Optional[str] = None,
                          device="cpu") -> Params:
    """Load and convert the whole reference checkpoint on `device`, with
    the frozen buffers (the VQ codebooks from their files where given),
    every floating leaf in `config.dtype`.  The checkpoint and codebooks
    are pickles, read with `torch.load(..., weights_only=False)` as the
    JAX package reads them: load only files you trust."""
    dt = torch_dtype(config.dtype)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    params = import_umgen(extract_state_dict(ckpt), config, device, dt)
    del ckpt

    def codebook(p):
        if not p:
            return None
        return torch.load(p, map_location="cpu",
                          weights_only=False).detach().float().numpy()

    # the JAX loader casts every floating leaf, the decode tables too
    params["buffers"] = _cast(build_buffers(
        config, pipeline=pipeline, map_codebook=codebook(map_codebook_path),
        img_codebook=codebook(img_codebook_path), device=device), dt)
    return params


# ---------------------------------------------------------------------------
# VQGAN import (umgen_tpu/runtime/torch_import.py:213-297)
# ---------------------------------------------------------------------------
class _VQReader:
    """Reads the VQGAN state dict's tensors in float32 on `device`."""

    def __init__(self, sd: Dict[str, Any], device):
        self.sd, self.device = sd, device

    def t(self, name: str) -> torch.Tensor:
        return self.sd[name].detach().to(device=self.device,
                                          dtype=torch.float32)

    def conv(self, name: str) -> Params:
        return {"w": self.t(f"{name}.weight").permute(2, 3, 1, 0)
                .contiguous(), "b": self.t(f"{name}.bias")}

    def gn(self, name: str) -> Params:
        return {"w": self.t(f"{name}.weight"), "b": self.t(f"{name}.bias")}

    def resnet(self, name: str) -> Params:
        p = {"norm1": self.gn(f"{name}.norm1"),
             "conv1": self.conv(f"{name}.conv1"),
             "norm2": self.gn(f"{name}.norm2"),
             "conv2": self.conv(f"{name}.conv2")}
        if f"{name}.nin_shortcut.weight" in self.sd:
            p["nin_shortcut"] = self.conv(f"{name}.nin_shortcut")
        return p

    def attn(self, name: str) -> Params:
        return {"norm": self.gn(f"{name}.norm"),
                **{n: self.conv(f"{name}.{n}")
                   for n in ("q", "k", "v", "proj_out")}}

    def mid(self, prefix: str) -> Params:
        return {"block_1": self.resnet(f"{prefix}.mid.block_1"),
                "attn_1": self.attn(f"{prefix}.mid.attn_1"),
                "block_2": self.resnet(f"{prefix}.mid.block_2")}

    def tower(self, prefix: str, n_blocks: int, n_levels: int,
              sub: str) -> list:
        """`up` / `down`: each level's blocks and attentions (lists), and
        its `sub` (upsample / downsample) conv where the state dict has
        one."""
        levels = []
        for i in range(n_levels):
            lvl = {"block": [], "attn": []}
            for j in range(n_blocks):
                bname = f"{prefix}.{i}.block.{j}"
                if f"{bname}.conv1.weight" not in self.sd:
                    break
                lvl["block"].append(self.resnet(bname))
                if f"{prefix}.{i}.attn.{j}.q.weight" in self.sd:
                    lvl["attn"].append(self.attn(f"{prefix}.{i}.attn.{j}"))
            if f"{prefix}.{i}.{sub}.conv.weight" in self.sd:
                lvl[sub] = {"conv": self.conv(f"{prefix}.{i}.{sub}.conv")}
            levels.append(lvl)
        return levels


def import_vq(state_dict: Dict[str, Any], cfg, device="cpu") -> Params:
    """VQGAN state dict (ref:vq_model.py NormVQModel) → the VQ tree, float32
    on `device`; the encoder and `quant_conv` where the state dict holds
    them."""
    r = _VQReader(state_dict, device)
    n_res = cfg.num_resolutions
    params: Params = {
        "decoder": {
            "conv_in": r.conv("decoder.conv_in"),
            "mid": r.mid("decoder"),
            "up": r.tower("decoder.up", cfg.num_res_blocks + 1, n_res,
                          "upsample"),
            "norm_out": r.gn("decoder.norm_out"),
            "conv_out": r.conv("decoder.conv_out"),
        },
        "codebook": r.t("quantize.embedding.weight"),
        "post_quant_conv": r.conv("post_quant_conv"),
    }
    if "encoder.conv_in.weight" in state_dict:
        params["encoder"] = {
            "conv_in": r.conv("encoder.conv_in"),
            "down": r.tower("encoder.down", cfg.num_res_blocks, n_res,
                            "downsample"),
            "mid": r.mid("encoder"),
            "norm_out": r.gn("encoder.norm_out"),
            "conv_out": r.conv("encoder.conv_out"),
        }
        params["quant_conv"] = r.conv("quant_conv")
    return params


def load_vq_checkpoint(path: str, cfg, device="cpu") -> Params:
    """A VQGAN checkpoint, with or without its {"state_dict": ...} wrapper
    (ref:vq_model.py:65-78), as the VQ tree on `device`.  A pickle, read
    with `torch.load(..., weights_only=False)` as the JAX package reads it:
    load only files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return import_vq(sd, cfg, device)
