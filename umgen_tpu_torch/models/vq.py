"""VQGAN detokenizers and tokenizer (port of umgen_tpu/models/vq.py).

The reference VQ stack (ref:projects/tokenizer/vq_model.py, vq_modules.py,
quantize.py) on cuDNN convolutions:

* the decoder — conv_in → mid(resnet, attn, resnet) → upsample tower →
  GroupNorm / swish / conv_out (ref:vq_modules.py:293-415);
* the encoder — the mirror-image downsampling tower (ref:vq_modules.py:
  179-290);
* NormVQ — an l2-normalized codebook: decode is an embedding lookup, encode
  the nearest (cosine) code (ref:quantize.py:370-479); FSQ beside it.

The param tree is the JAX package's: the same names, lists for `up`,
`down`, `block` and `attn`, conv weights HWIO as the initializers and the
importer (runtime.torch_import.import_vq) build them.  The functions that
run the model take the tree with its conv weights OIHW, cuDNN's layout —
`oihw` converts it once, and the codecs below do that when they are built
— and run on NCHW activations inside; at their boundary images and
latents stay NHWC as in JAX.  Every product is float32: `float32_products`
keeps TF32 off for cuDNN and cuBLAS while the codecs run.

Two configs mirror the checkpoints (ref:vq_model.py:150-202): map = 8192×16
codebook, z = 16, ch_mult (1, 2, 2, 4), attn@16, a 1×1 post-quant conv;
image = z = 256, ch_mult (1, 1, 2, 2, 4), attn@32, a 3×3 post-quant conv.
The reference's NormVQModel passes its `stride` argument into Conv2d's
kernel_size slot (ref:vq_model.py:137-142), so "stride 1 / padding 0" is a
1×1 post-quant conv; the port keeps that.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VQConfig:
    n_embed: int = 8192
    embed_dim: int = 16
    z_channels: int = 16
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 5
    out_ch: int = 5
    resolution: int = 256
    post_quant_kernel: int = 1        # map: 1 (pad 0); image: 3 (pad 1)

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)


MAP_VQ = VQConfig()                   # ref:vq_model.py:178-202
IMAGE_VQ = VQConfig(z_channels=256, ch_mult=(1, 1, 2, 2, 4),
                    attn_resolutions=(32,), in_channels=3, out_ch=3,
                    resolution=512, post_quant_kernel=3)


@contextlib.contextmanager
def float32_products():
    """TF32 off for cuBLAS and cuDNN inside (the package turns it off at
    import; this keeps it off whatever a caller set since)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def oihw(tree: Params, device=None) -> Params:
    """The tree with every conv weight (a 4-D "w") HWIO → OIHW, contiguous,
    every leaf on `device`."""
    if isinstance(tree, dict):
        return {k: (v.permute(3, 2, 0, 1).contiguous().to(device)
                    if k == "w" and v.dim() == 4 else oihw(v, device))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [oihw(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# primitive ops (NCHW activations, OIHW weights)
# ---------------------------------------------------------------------------
def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    pad = {"SAME": p["w"].shape[-1] // 2, "VALID": 0}[padding]
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad)


def group_norm(p: Params, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """32 groups, biased variance in float32, eps 1e-6 (torch's default is
    1e-5)."""
    return F.group_norm(x.float(), groups, p["w"], p["b"], eps).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def resnet_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], swish(group_norm(p["norm1"], x)))
    h = conv2d(p["conv2"], swish(group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def attn_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head full self-attention over H*W (ref:vq_modules.py:131-176),
    the softmax in float32."""
    N, C, H, W = x.shape
    h = group_norm(p["norm"], x)
    q, k, v = (conv2d(p[n], h).reshape(N, C, H * W) for n in "qkv")
    w = torch.bmm(q.transpose(1, 2), k).float() * (C ** -0.5)
    w = torch.softmax(w, dim=-1).to(x.dtype)
    out = torch.bmm(v, w.transpose(1, 2)).reshape(N, C, H, W)
    return x + conv2d(p["proj_out"], out)


def upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    return conv2d(p["conv"], F.interpolate(x, scale_factor=2,
                                           mode="nearest"))


def downsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """stride-2 conv with torch's asymmetric (0,1,0,1) padding
    (ref:vq_modules.py:43-60)."""
    return conv2d(p["conv"], F.pad(x, (0, 1, 0, 1)), stride=2,
                  padding="VALID")


# ---------------------------------------------------------------------------
# init (the JAX initializers' names, shapes and scales; HWIO conv weights)
# ---------------------------------------------------------------------------
class _Init:
    def __init__(self, generator: torch.Generator, device):
        self.g, self.device = generator, device

    def conv(self, cin, cout, k) -> Params:
        w = torch.randn(k, k, cin, cout, generator=self.g,
                        device=self.device)
        return {"w": w / math.sqrt(cin * k * k),
                "b": torch.zeros(cout, device=self.device)}

    def gn(self, c) -> Params:
        return {"w": torch.ones(c, device=self.device),
                "b": torch.zeros(c, device=self.device)}

    def resnet(self, cin, cout) -> Params:
        p = {"norm1": self.gn(cin), "conv1": self.conv(cin, cout, 3),
             "norm2": self.gn(cout), "conv2": self.conv(cout, cout, 3)}
        if cin != cout:
            p["nin_shortcut"] = self.conv(cin, cout, 1)
        return p

    def attn(self, c) -> Params:
        return {"norm": self.gn(c), "q": self.conv(c, c, 1),
                "k": self.conv(c, c, 1), "v": self.conv(c, c, 1),
                "proj_out": self.conv(c, c, 1)}

    def mid(self, c) -> Params:
        return {"block_1": self.resnet(c, c), "attn_1": self.attn(c),
                "block_2": self.resnet(c, c)}


def init_decoder(generator: torch.Generator, cfg: VQConfig,
                 device) -> Params:
    ini = _Init(generator, device)
    block_in = cfg.ch * cfg.ch_mult[-1]
    curr_res = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
    p: Params = {"conv_in": ini.conv(cfg.z_channels, block_in, 3),
                 "mid": ini.mid(block_in)}
    ups = [None] * cfg.num_resolutions
    for i_level in reversed(range(cfg.num_resolutions)):
        blocks, attns = [], []
        block_out = cfg.ch * cfg.ch_mult[i_level]
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(ini.resnet(block_in, block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                attns.append(ini.attn(block_in))
        up = {"block": blocks, "attn": attns}
        if i_level != 0:
            up["upsample"] = {"conv": ini.conv(block_in, block_in, 3)}
            curr_res *= 2
        ups[i_level] = up
    p["up"] = ups
    p["norm_out"] = ini.gn(block_in)
    p["conv_out"] = ini.conv(block_in, cfg.out_ch, 3)
    return p


def init_encoder(generator: torch.Generator, cfg: VQConfig,
                 device) -> Params:
    ini = _Init(generator, device)
    p: Params = {"conv_in": ini.conv(cfg.in_channels, cfg.ch, 3),
                 "down": []}
    curr_res = cfg.resolution
    in_mult = (1,) + tuple(cfg.ch_mult)
    for i_level in range(cfg.num_resolutions):
        blocks, attns = [], []
        block_in = cfg.ch * in_mult[i_level]
        block_out = cfg.ch * cfg.ch_mult[i_level]
        for _ in range(cfg.num_res_blocks):
            blocks.append(ini.resnet(block_in, block_out))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                attns.append(ini.attn(block_in))
        down = {"block": blocks, "attn": attns}
        if i_level != cfg.num_resolutions - 1:
            down["downsample"] = {"conv": ini.conv(block_in, block_in, 3)}
            curr_res //= 2
        p["down"].append(down)
    p["mid"] = ini.mid(block_in)
    p["norm_out"] = ini.gn(block_in)
    p["conv_out"] = ini.conv(block_in, cfg.z_channels, 3)
    return p


def init_normvq(generator: torch.Generator, cfg: VQConfig,
                device) -> Params:
    """Full model: encoder + decoder + codebook + quant convs (HWIO)."""
    ini = _Init(generator, device)
    p = {"encoder": init_encoder(generator, cfg, device),
         "decoder": init_decoder(generator, cfg, device)}
    emb = torch.randn(cfg.n_embed, cfg.embed_dim, generator=generator,
                      device=device)
    p["codebook"] = emb / torch.linalg.norm(emb, dim=-1, keepdim=True)
    p["quant_conv"] = ini.conv(cfg.z_channels, cfg.embed_dim, 1)
    p["post_quant_conv"] = ini.conv(cfg.embed_dim, cfg.z_channels,
                                    cfg.post_quant_kernel)
    return p


# ---------------------------------------------------------------------------
# forward (OIHW params; NHWC at the boundary)
# ---------------------------------------------------------------------------
def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _decoder(p: Params, cfg: VQConfig, h: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv_in"], h)
    h = resnet_block(p["mid"]["block_1"], h)
    h = attn_block(p["mid"]["attn_1"], h)
    h = resnet_block(p["mid"]["block_2"], h)
    for i_level in reversed(range(cfg.num_resolutions)):
        up = p["up"][i_level]
        for i_block in range(cfg.num_res_blocks + 1):
            h = resnet_block(up["block"][i_block], h)
            if up["attn"]:
                h = attn_block(up["attn"][i_block], h)
        if i_level != 0:
            h = upsample(up["upsample"], h)
    h = swish(group_norm(p["norm_out"], h))
    return conv2d(p["conv_out"], h)


def decoder_forward(p: Params, cfg: VQConfig, z: torch.Tensor
                    ) -> torch.Tensor:
    """z [N, h, w, z_channels] → image [N, H, W, out_ch]."""
    return _nhwc(_decoder(p, cfg, _nchw(z)))


def encoder_forward(p: Params, cfg: VQConfig, x: torch.Tensor
                    ) -> torch.Tensor:
    """image [N, H, W, in_ch] → z [N, h, w, z_channels]."""
    return _nhwc(_encoder(p, cfg, _nchw(x)))


def _encoder(p: Params, cfg: VQConfig, h: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv_in"], h)
    for i_level in range(cfg.num_resolutions):
        down = p["down"][i_level]
        for i_block in range(cfg.num_res_blocks):
            h = resnet_block(down["block"][i_block], h)
            if down["attn"]:
                h = attn_block(down["attn"][i_block], h)
        if i_level != cfg.num_resolutions - 1:
            h = downsample(down["downsample"], h)
    h = resnet_block(p["mid"]["block_1"], h)
    h = attn_block(p["mid"]["attn_1"], h)
    h = resnet_block(p["mid"]["block_2"], h)
    h = swish(group_norm(p["norm_out"], h))
    return conv2d(p["conv_out"], h)


def decode_code(p: Params, cfg: VQConfig, indices: torch.Tensor
                ) -> torch.Tensor:
    """VQ indices [N, h, w] → image [N, H, W, out_ch]
    (ref:vq_model.py:92-96)."""
    quant = _nchw(p["codebook"][indices])               # [N, e, h, w]
    return _nhwc(_decoder(p["decoder"], cfg,
                          conv2d(p["post_quant_conv"], quant)))


def encode_to_indices(p: Params, cfg: VQConfig, x: torch.Tensor
                      ) -> torch.Tensor:
    """image [N, H, W, in_ch] → VQ indices [N, h, w] via l2-normalized
    nearest-code assignment (ref:quantize.py:414-431)."""
    z = _nhwc(conv2d(p["quant_conv"], _encoder(p["encoder"], cfg,
                                               _nchw(x))))
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    emb = p["codebook"]
    d = (torch.sum(z ** 2, dim=-1, keepdim=True) + torch.sum(emb ** 2, dim=-1)
         - 2 * torch.einsum("nhwc,ec->nhwe", z, emb))
    return torch.argmin(d, dim=-1)


# ---------------------------------------------------------------------------
# FSQ — finite scalar quantization (ref:quantize.py:230-288; present in the
# reference's quantizer zoo though the shipped checkpoints use NormEMA)
# ---------------------------------------------------------------------------
class FSQ:
    """Finite Scalar Quantizer (https://arxiv.org/abs/2309.15505 recipe)."""

    def __init__(self, levels: Sequence[int]):
        self.levels = torch.tensor(levels, dtype=torch.int32)
        self.basis = torch.from_numpy(np.concatenate(
            [[1], np.cumprod(np.asarray(levels[:-1]))]).astype(np.int64))
        self.n_codes = int(np.prod(levels))

    def _half_width(self, device) -> torch.Tensor:
        return torch.div(self.levels.to(device).float(), 2,
                         rounding_mode="floor")

    def _bound(self, z: torch.Tensor) -> torch.Tensor:
        levels = self.levels.to(z.device)
        half = (levels.float() - 1) * (1 + 1e-3) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.tan(offset / half)
        return torch.tanh(z + shift) * half - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """(..., d) → quantized values in the same space (straight-through
        rounding on the bounded lattice)."""
        zb = self._bound(z)
        q = zb + (torch.round(zb) - zb).detach()
        return q / self._half_width(z.device)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        half_width = self._half_width(zhat.device)
        centered = zhat * half_width + half_width
        return torch.sum(centered.long() * self.basis.to(zhat.device),
                         dim=-1).int()

    def indices_to_codes(self, idx: torch.Tensor) -> torch.Tensor:
        half_width = self._half_width(idx.device)
        codes = torch.div(idx[..., None], self.basis.to(idx.device),
                          rounding_mode="floor") % self.levels.to(idx.device)
        return (codes.float() - half_width) / half_width


# ---------------------------------------------------------------------------
# detokenizer front-ends (ref:tools/decode_map.py:110-183)
# ---------------------------------------------------------------------------
# jax.random.normal(jax.random.PRNGKey(0), (1, 1, 5, 3), float32)[0, 0]: the
# JAX package's map → RGB projection, as float32 values (the port cannot draw
# from JAX's generator; tests/test_torch_vq.py holds the table against it)
TO_RGB_W = ((1.622642159461975, 2.0252647399902344, -0.4335944354534149),
            (-0.07861734926700592, 0.17609089612960815, -0.9720892310142517),
            (-0.49529874324798584, 0.49437859654426575, 0.6643493175506592),
            (-0.9501634836196899, 2.179530382156372, -1.9551506042480469),
            (0.35857072472572327, 0.15779513120651245, 1.2770847082138062))


def to_rgb(x: torch.Tensor) -> torch.Tensor:
    """The 5-channel map raster [N, H, W, 5] → RGB by a fixed random 1×1
    projection (`TO_RGB_W`), normalized to [-1, 1] by the min and max of
    the whole chunk (ref:decode_map.py:25-30 uses torch.manual_seed(0) +
    randn; the JAX package a fixed key; for visualization only)."""
    y = x @ torch.tensor(TO_RGB_W, dtype=x.dtype, device=x.device)
    lo, hi = y.min(), y.max()
    return 2.0 * (y - lo) / (hi - lo) - 1.0


def _seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class _Codec:
    """`params`: the HWIO tree (init_normvq, import_vq), seeded at random
    on `device` when None; `self.params` holds it with OIHW conv
    weights."""

    def __init__(self, cfg: VQConfig, params: Optional[Params] = None,
                 seed: int = 0, device="cuda"):
        self.cfg, self.device = cfg, torch.device(device)
        if not params:
            params = init_normvq(_seeded(seed, self.device), cfg,
                                 self.device)
        self.params = oihw(params, self.device)


class NormVQTokenizer(_Codec):
    """Image / raster ↔ VQ-token codec — the encode-path API the reference
    promises (ref:tokenizer/base.py QuantizedToken + vq_tokenizer.py
    NormVQModelTokenizer).

    encode: [N, H, W, C] in [-1, 1] → indices [N, h, w]
    decode: indices → reconstruction [N, H, W, C]
    """

    @torch.no_grad()
    def encode(self, images: np.ndarray) -> np.ndarray:
        x = torch.tensor(np.asarray(images), device=self.device)
        with float32_products():
            return encode_to_indices(self.params, self.cfg, x).cpu().numpy()

    @torch.no_grad()
    def decode(self, indices: np.ndarray) -> np.ndarray:
        idx = torch.tensor(np.asarray(indices), dtype=torch.long,
                           device=self.device)
        with float32_products():
            return decode_code(self.params, self.cfg, idx).cpu().numpy()

    def roundtrip(self, images: np.ndarray) -> np.ndarray:
        return self.decode(self.encode(images))


class _Detokenizer(_Codec):
    """A token stream (T, h·w) → pictures (T, H, W, C) in chunks of
    `chunk` frames, NHWC float32 numpy."""

    grid: Tuple[int, int]

    def _pictures(self, idx: torch.Tensor) -> torch.Tensor:
        return decode_code(self.params, self.cfg, idx)

    @torch.no_grad()
    def decode(self, tokens: np.ndarray, chunk: int = 20) -> np.ndarray:
        tokens = np.asarray(tokens).reshape(-1, *self.grid)
        outs = []
        with float32_products():
            for i in range(0, tokens.shape[0], chunk):
                idx = torch.tensor(tokens[i:i + chunk], dtype=torch.long,
                                   device=self.device)
                outs.append(self._pictures(idx).cpu().numpy())
        return np.concatenate(outs, axis=0)


class MapDecoder(_Detokenizer):
    """map tokens (T, 1024) → RGB rasters (T, 256, 256, 3) in [-1, 1].  A
    chunk is normalized as a whole (`to_rgb`), so the chunk of 20 frames
    is part of the result: a 21-frame clip's last frame is normalized
    alone."""

    grid = (32, 32)

    def __init__(self, params: Optional[Params] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(MAP_VQ, params, seed, device)

    def _pictures(self, idx: torch.Tensor) -> torch.Tensor:
        return to_rgb(super()._pictures(idx))


class ImageDecoder(_Detokenizer):
    """image tokens (T, 512) → images (T, 256, 512, 3) in [-1, 1]."""

    grid = (16, 32)

    def __init__(self, params: Optional[Params] = None, seed: int = 0,
                 device="cuda"):
        super().__init__(IMAGE_VQ, params, seed, device)
