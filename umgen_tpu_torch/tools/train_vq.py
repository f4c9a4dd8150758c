"""VQ codec training CLI (port of umgen_tpu/tools/train_vq.py): the map /
image NormVQ tokenizers' reconstruction + commitment training around the
EMA codebook (models/quantize.py), on one card:

    python -m umgen_tpu_torch.tools.train_vq --target map --steps 200 \\
        --batch_size 8 --res 64 --ch 32
    python -m umgen_tpu_torch.tools.train_vq --device cpu --res 32 --ch 32 \\
        --steps 3

The JAX CLI's flags and defaults, plus `--device`.  The params keep the
JAX package's tree (HWIO conv weights: `vq.oihw` converts them inside the
step, under autograd); Adam(lr) updates them (parallel/optim.py); the EMA
codebook is updated outside the gradient.  Every product is float32
(`vq.float32_products` keeps TF32 off, cuDNN's backward convolutions
included).  The run is saved in the inference layout (`codebook` = the EMA
embedding) to `<ckpt_dir>/<target>_final` (runtime/checkpoint.py), which
models.vq's MapDecoder / ImageDecoder load.  `--dp` above 1 raises
NotPortedError (ROADMAP Queue 1 item 5, 'Multi-GPU and runtime').
"""

from __future__ import annotations

import argparse
import dataclasses
import time
import numpy as np


def synthetic_rasters(rng: np.random.Generator, n: int, res: int,
                      channels: int) -> np.ndarray:
    """Smooth random blob fields in [-1, 1] — enough structure for the
    codec to learn a non-trivial codebook on any host (numpy: the JAX
    CLI's rasters)."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    out = np.zeros((n, res, res, channels), np.float32)
    for i in range(n):
        for _ in range(6):
            cx, cy = rng.uniform(0, 1, 2)
            s = rng.uniform(0.05, 0.25)
            amp = rng.uniform(-1, 1, channels).astype(np.float32)
            g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
            out[i] += g[..., None] * amp
    return np.tanh(out)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="NormVQ codec training "
                                 "(PyTorch)")
    ap.add_argument("--target", choices=("map", "image"), default="map")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dp", type=int, default=1,
                    help="not ported: values above 1 raise")
    ap.add_argument("--res", type=int, default=0,
                    help="override resolution (small for CPU smoke runs)")
    ap.add_argument("--ch", type=int, default=0,
                    help="override base channel count")
    ap.add_argument("--n_embed", type=int, default=0)
    ap.add_argument("--kmeans", action="store_true",
                    help="k-means codebook init on the first batch "
                    "(ref:quantize.py:290-338)")
    ap.add_argument("--ckpt_dir", default="output/vq_ckpt")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the CPU only when asked (cpu)")
    return ap


def vq_config(args):
    """MAP_VQ / IMAGE_VQ with the `--res` / `--ch` / `--n_embed`
    overrides."""
    from umgen_tpu_torch.models import vq
    cfg = vq.MAP_VQ if args.target == "map" else vq.IMAGE_VQ
    overrides = {}
    if args.res:
        overrides["resolution"] = args.res
    if args.ch:
        overrides["ch"] = args.ch
    if args.n_embed:
        overrides["n_embed"] = args.n_embed
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.ch % 32:
        raise SystemExit("--ch must be a multiple of 32 (GroupNorm(32) "
                         "inside the VQGAN blocks)")
    return cfg


class VQTrainer:
    """The CLI's step on a codec: `step(x)` takes rasters [N, H, W, C]
    (float32, on the device) and updates the params, the Adam state and
    the EMA codebook; returns {"loss", "rec", "perp"} device tensors."""

    def __init__(self, cfg, params, lr: float, kmeans: bool = False):
        import torch

        from umgen_tpu_torch.models.quantize import init_ema_state
        from umgen_tpu_torch.parallel import optim
        self.cfg = cfg
        self.kmeans = kmeans
        # the trainable tree: every leaf but the codebook, as autograd
        # leaves
        self.params = optim.tree_map(
            lambda t: t.detach().requires_grad_(True),
            {k: v for k, v in params.items() if k != "codebook"})
        dev = params["codebook"].device
        self.ema = init_ema_state(None, cfg.n_embed, cfg.embed_dim,
                                  codebook=params["codebook"], device=dev)
        if kmeans:
            self.ema = self.ema._replace(
                embedding=torch.zeros_like(self.ema.embedding),
                initted=torch.tensor(False, device=dev))
        self.tx = optim.adam(lr)
        with torch.no_grad():
            self.opt_state = self.tx.init(self.params)

    def _encode(self, p, x):
        from umgen_tpu_torch.models import vq
        return vq._nhwc(vq.conv2d(p["quant_conv"], vq._encoder(
            p["encoder"], self.cfg, vq._nchw(x))))

    def loss_fn(self, params, ema, x):
        import torch

        from umgen_tpu_torch.models import vq
        from umgen_tpu_torch.models.quantize import norm_ema_quantize
        p = vq.oihw(params)
        z = self._encode(p, x)
        zq, commit, idx, ema2 = norm_ema_quantize(ema, z, train=True)
        zq = vq.conv2d(p["post_quant_conv"], vq._nchw(zq))
        recon = vq._nhwc(vq._decoder(p["decoder"], self.cfg, zq))
        rec = torch.mean((recon - x) ** 2)
        return rec + commit, (ema2, rec, idx)

    def step(self, x, generator=None):
        import torch

        from umgen_tpu_torch.models import vq
        from umgen_tpu_torch.models.quantize import maybe_kmeans_init
        from umgen_tpu_torch.parallel import optim
        with vq.float32_products():
            if self.kmeans and not bool(self.ema.initted):
                with torch.no_grad():
                    z = self._encode(vq.oihw(self.params), x)
                self.ema = maybe_kmeans_init(self.ema, z, generator)
            with torch.enable_grad():
                loss, (ema, rec, idx) = self.loss_fn(self.params, self.ema,
                                                     x)
                grads = optim.grads(loss, self.params)
            with torch.no_grad():
                updates, self.opt_state = self.tx.update(
                    grads, self.opt_state, self.params)
                new = optim.apply_updates(self.params, updates)
                optim.tree_map(lambda p, n: p.copy_(n), self.params, new)
                self.ema = ema
                # perplexity of this step's code usage (codebook health)
                probs = torch.nn.functional.one_hot(
                    idx.reshape(-1), self.cfg.n_embed).float().mean(0)
                perp = torch.exp(-torch.sum(probs
                                            * torch.log(probs + 1e-10)))
        return {"loss": loss.detach(), "rec": rec.detach(), "perp": perp}

    def inference_params(self):
        """The trained tree in the inference layout: `codebook` = the EMA
        embedding (what MapDecoder / ImageDecoder load)."""
        from umgen_tpu_torch.parallel import optim
        full = optim.tree_map(lambda t: t.detach(), self.params)
        full["codebook"] = self.ema.embedding
        return full


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from umgen_tpu_torch.models import vq
    from umgen_tpu_torch.models.umgen import NotPortedError
    from umgen_tpu_torch.runtime import checkpoint as ckpt

    if args.dp > 1:
        raise NotPortedError(
            f"--dp {args.dp}: data-parallel codec training is ROADMAP Queue "
            "1 item 5, 'Multi-GPU and runtime'")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card; "
                           "pass --device cpu to train on the CPU")
    cfg = vq_config(args)
    params = vq.init_normvq(torch.Generator(device).manual_seed(args.seed),
                            cfg, device)
    trainer = VQTrainer(cfg, params, args.lr, kmeans=args.kmeans)
    gen = torch.Generator(device).manual_seed(args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(1, args.steps + 1):
        x = torch.as_tensor(synthetic_rasters(rng, args.batch_size,
                                              cfg.resolution,
                                              cfg.in_channels),
                            device=device)
        m = trainer.step(x, gen)
        if i % args.log_every == 0 or i == args.steps:
            print(f"step {i}/{args.steps} loss={float(m['loss']):.4f} "
                  f"(rec {float(m['rec']):.4f}) "
                  f"perplexity={float(m['perp']):.1f} "
                  f"{time.time() - t0:.1f}s", flush=True)

    path = ckpt.save_params(f"{args.ckpt_dir}/{args.target}_final",
                            trainer.inference_params())
    print(f"saved {path}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
