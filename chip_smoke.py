"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX.  Phases:

  (a) build the port's CUDA kernels from umgen_tpu_torch/csrc/ (nvcc);
  (b) hold each kernel against its plain PyTorch version on the card, at
      the shapes the cached rollout gives it, and time both;
  (c) run the UMGen_Large cached video rollout (36-layer stacks, d = 768,
      seeded random weights on the card, one synthetic scene, B = 1)
      through the CLI's code path (umgen_tpu_torch.tools.evaluate), with
      every kernel's launch count reset just before: the prefill frame
      plus two cached frames.  Tokens must lie in their modalities'
      ranges, logits and priors must be finite, and every kernel must have
      launched;
  (d) run one prefill frame of the model at full width with one-layer
      stacks on the card and, from the same weights, on the CPU (the plain
      versions), the CPU replaying the card's greedy decisions: tokens
      equal, ego logits, TAR priors and every decision's logits close.

Prints each phase's results, the card's name and power limit, a JSON line
describing the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero without that line.  Details land in
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# tolerances, stated before measuring:
# flash: bf16 outputs of unit-normal q/k/v.  Both sides round the softmax
#   weights to bf16 (the kernel the unnormalized ones, the plain version
#   the normalized ones) and sum in another order: two independent
#   roundings of 2^-9 relative, averaged over the keys, move an output by
#   ~2^-9.3 of its size before the final bf16 rounding, which then differs
#   by one ulp in about a third of the elements.  Bounds: no element
#   further than 4 bf16 ulps of the largest output (4 * 2^-8 * max|ref|),
#   and a mean error within 2^-8 of the mean |ref|.  The phase also checks
#   that these bounds reject three planted faults on the same inputs: a
#   softmax scale 15% off, a dropped 64-key tile, and value sums carried
#   in bf16 across key tiles.
FLASH_RTOL_MAX = 4 * 2.0 ** -8
FLASH_RTOL_MEAN = 2.0 ** -8
# decode step: exact int8 products on both sides; the prefix attention
#   rounds its softmax weights to bf16 under another blocking and sums in
#   another order, which flips an occasional int8 re-quantization of the
#   attention output.  One layer: the hidden state agrees to a few bf16 ulps
#   (2^-8 of its scale).  Through 36 layers of random weights the flips
#   compound (measured on an H100: 0.5% at 1 layer, 2.5% at 8, 7.5% at 36
#   with +-6.25 random caches), so the 36-layer bound only catches gross
#   faults.  New K/V rows of layer 0 see identical inputs: equal up to one
#   grid step at rounding ties.  At cache_len 0 a Q = 1 step attends only
#   to itself, and the kernel (built with --fmad=false) rounds where the
#   plain version does: h and every layer's new K/V rows must be equal bit
#   for bit, which pins each layer's weight, vector and cache offsets.
DECODE_RTOL_1 = 2e-2
DECODE_RTOL_36 = 0.15
KV_LAYER0_ATOL = 1
# the model on the card against the plain versions on the CPU (phase d,
#   one layer per stack at full width): ego logits and TAR priors are bf16
#   outputs of the same ops, where the flash kernel and cuBLAS round and sum
#   in another order than the CPU — a few bf16 ulps per stack, four stacks
#   deep; a decision's logits sit behind one decode-step layer (<= 2e-2 of
#   its scale, above) and a bf16 head.  Relative to each tensor's max |.|.
REF_RTOL_PRIORS = 2e-2
REF_RTOL_LOGITS = 5e-2


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from umgen_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.load()
    secs = time.perf_counter() - t0
    log = (_cuda.BUILD_DIR / "build.log").read_text()
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print(f"(a) built {path.name} in {secs:.1f} s")
    return {"seconds": secs, "library": path.name}


def flash_errors(out, ref):
    """(max |out - ref| / max |ref|, mean |out - ref| / mean |ref|)."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    return (d.max() / r.max()).item(), (d.mean() / r.mean()).item()


def flash_ok(errs) -> bool:
    return (all(math.isfinite(e) for e in errs)
            and errs[0] <= FLASH_RTOL_MAX and errs[1] <= FLASH_RTOL_MEAN)


def _flash_bf16_carry(q, k, v, tile=64):
    """Planted fault: the plain attention with the unnormalized value sums
    rounded to bf16 after every key tile."""
    import torch
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = torch.zeros(*p.shape[:3], v.shape[-1], device=q.device)
    pb = p.bfloat16().float()
    for t in range(0, k.shape[1], tile):
        acc = (acc + torch.einsum("bhqk,bkhd->bhqd", pb[..., t:t + tile],
                                  v[:, t:t + tile].float())).bfloat16().float()
    return (acc / p.sum(-1, keepdim=True)).transpose(1, 2).bfloat16()


def planted_flash_faults(q, k, v, out):
    """The flash check's readings against three wrong references; each
    must fail the check."""
    from umgen_tpu_torch.ops import flash_attention as fa
    faults = {
        "scale_x0.85": fa.flash_attention_plain(
            (q.float() * 0.85).bfloat16(), k, v, False),
        "dropped_64_key_tile": fa.flash_attention_plain(
            q, k[:, 64:], v[:, 64:], False),
        "bf16_value_sums": _flash_bf16_carry(q, k, v)}
    readings = {name: flash_errors(out, ref) for name, ref in faults.items()}
    passed = [name for name, e in readings.items() if flash_ok(e)]
    if passed:
        raise AssertionError(f"the flash check passes planted faults "
                             f"{passed}: {readings}")
    return readings


def phase_flash(dev):
    import torch
    from umgen_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cases = [  # (B, Sq, Sk, causal): prefill window, one frame, batch 2,
        (20, 2207, 2207, False), (1, 2207, 2207, False),   # map stack,
        (2, 2207, 2207, False), (1, 1031, 1031, False),    # causal Sq<Sk
        (1, 1031, 2207, True)]
    rows, worst, planted = [], 0.0, None
    for B, Sq, Sk, causal in cases:
        def rnd(S, n=1):
            return torch.randn(B, S, n * 768, generator=g, device=dev,
                               dtype=torch.float32).to(torch.bfloat16)
        if Sq == Sk:   # self-attention: views of a fused qkv, as in the model
            q, k, v = (t.reshape(B, Sq, 16, 48)
                       for t in rnd(Sq, 3).split(768, dim=-1))
        else:
            q, k, v = (rnd(S).reshape(B, S, 16, 48) for S in (Sq, Sk, Sk))
        out = fa.flash_attention(q, k, v, causal)
        ref = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        errs = flash_errors(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        if not flash_ok(errs):
            raise AssertionError(
                f"flash {B, Sq, Sk, causal}: error {errs[0]:.3g} of max "
                f"|ref| (bound {FLASH_RTOL_MAX:.3g}), mean {errs[1]:.3g} of "
                f"mean |ref| (bound {FLASH_RTOL_MEAN:.3g})")
        worst = max(worst, err)
        if (B, Sq, causal) == (1, 2207, False):
            planted = planted_flash_faults(q, k, v, out)
        reps = 3 if B > 2 else 20
        ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal), reps)
        pms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                       max(1, reps // 4), warmup=1)
        rows.append({"B": B, "Sq": Sq, "Sk": Sk, "causal": causal,
                     "max_abs_err": err, "rel_err_max": errs[0],
                     "rel_err_mean": errs[1], "ms": ms, "plain_ms": pms})
        print(f"(b) flash B={B} Sq={Sq} Sk={Sk} causal={causal}: max abs "
              f"err {err:.3g} ({errs[0]:.3g} of max |ref|, mean "
              f"{errs[1]:.3g} of mean |ref|), kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms")
    print("(b) flash check against planted faults (max, mean; each must "
          "fail): " + ", ".join(f"{k} {e[0]:.3g} / {e[1]:.3g}"
                               for k, e in planted.items()))
    return rows, worst, planted


def _decode_params(dev):
    import torch
    from umgen_tpu.config import ModelConfig
    from umgen_tpu_torch.params import _Init
    from umgen_tpu_torch.runtime.quantize import (pack_decode_weights,
                                                  quantize_params_int8)
    cfg = ModelConfig()
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    ini = _Init(g, dev, torch.bfloat16)
    oar = ini.block_oar(cfg.n_embd, cfg.n_oar_layer)
    # LN weights and biases away from their init values, so every packed
    # vector slot is exercised
    for ln in ("ln1", "ln2"):
        oar[ln]["w"] = (1 + 0.1 * torch.randn(oar[ln]["w"].shape,
                                              generator=g, device=dev)
                        ).to(torch.bfloat16)
    for lin in ("qkv", "proj"):
        b = oar["attn"][lin]["b"]
        oar["attn"][lin]["b"] = (0.02 * torch.randn(b.shape, generator=g,
                                                    device=dev)).to(b.dtype)
    q = quantize_params_int8({"oar": oar})
    return cfg, pack_decode_weights(q["oar"])


def phase_decode(dev):
    import torch
    from umgen_tpu_torch.ops import decode_kernel as dk
    cfg, packed = _decode_params(dev)
    L, d, H = cfg.n_oar_layer, cfg.n_embd, cfg.n_head
    S = 2208
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    cases = [("v5", 1, 1, 0), ("v5", 1, 1, 1100), ("v5", 1, 1, 2206),
             ("v5", 2, 1, 0), ("v5", 2, 1, 1100), ("v5", 2, 1, 2206),
             ("v5mq", 1, 6, 0), ("v5mq", 2, 6, 0), ("v5mq", 1, 2, 1030),
             ("v5mq", 2, 2, 2205)]
    rows = {"v5": [], "v5mq": []}
    for name, B, Q, cl in cases:
        kv = torch.randint(-100, 101, (2, L, B, S, d), generator=g,
                           device=dev, dtype=torch.int8)
        x = torch.randn(B, Q, d, generator=g, device=dev).to(torch.bfloat16)
        kk, vk = kv[0].clone(), kv[1].clone()
        kp, vp = kv[0].clone(), kv[1].clone()
        fn = (dk.fused_decode_step_v5 if name == "v5"
              else dk.fused_decode_step_v5mq)
        one = {k: v[:1] for k, v in packed.items()}
        h1, _, _ = fn(one, x, kk[:1].clone(), vk[:1].clone(), cl, n_head=H)
        h1ref = dk.decode_step_plain(one, x, kp[:1].clone(), vp[:1].clone(),
                                     cl, H)
        h, _, _ = fn(packed, x, kk, vk, cl, n_head=H)
        href = dk.decode_step_plain(packed, x, kp, vp, cl, H)
        torch.cuda.synchronize()
        rel1 = ((h1.float() - h1ref.float()).abs().max()
                / h1ref.float().abs().max()).item()
        err = (h.float() - href.float()).abs().max().item()
        rel = err / href.float().abs().max().item()
        dkv = torch.stack([
            (kk[:, :, cl:cl + Q].int() - kp[:, :, cl:cl + Q].int()).abs(),
            (vk[:, :, cl:cl + Q].int() - vp[:, :, cl:cl + Q].int()).abs()])
        dkv0 = dkv[:, 0].max().item()
        untouched = all(torch.equal(a[:, :, :cl], b[:, :, :cl])
                        and torch.equal(a[:, :, cl + Q:], b[:, :, cl + Q:])
                        for a, b in ((kk, kp), (vk, vp)))
        exact = name == "v5" and cl == 0
        if not (math.isfinite(rel) and rel1 <= DECODE_RTOL_1
                and rel <= DECODE_RTOL_36 and dkv0 <= KV_LAYER0_ATOL
                and untouched
                and (not exact or (err == 0 and dkv.max().item() == 0))):
            raise AssertionError(
                f"{name} B={B} Q={Q} cache_len={cl}: h rel err {rel1} at 1 "
                f"layer, {rel} at {L} (must be 0 here: {exact}); K/V row err "
                f"{dkv0} at layer 0, {dkv.max().item()} at any; rest of the "
                f"caches untouched: {untouched}")
        ms = _time_ms(lambda: fn(packed, x, kk, vk, cl, n_head=H), 20)
        pms = _time_ms(lambda: dk.decode_step_plain(packed, x, kp, vp, cl,
                                                    H), 2, warmup=1)
        rows[name].append({"B": B, "Q": Q, "cache_len": cl,
                           "max_abs_err": err, "rel_err": rel,
                           "rel_err_1_layer": rel1,
                           "kv_max_err_all_layers": dkv.max().item(),
                           "ms": ms, "plain_ms": pms})
        print(f"(b) {name} B={B} Q={Q} cache_len={cl}: h rel err "
              f"{rel1:.3g} (1 layer) / {rel:.3g} ({L} layers, max abs "
              f"{err:.3g}), new K/V rows max err layer 0 {dkv0} / all "
              f"layers {dkv.max().item()}, kernel {ms:.3f} ms, plain "
              f"{pms:.1f} ms")
        del kv, kk, vk, kp, vp
    return rows


def phase_reference(dev, scale="debug"):
    """One prefill frame of the cached rollout, B = 1, a 2-frame window,
    greedy, with every stack one layer deep at the scale's full width: once
    on `dev` and once on the CPU (the plain versions) from the same
    weights.  The CPU run replays the device run's sampler decisions, so
    both decode one token stream; the tokens must be equal, and the ego
    logits, TAR priors and every decision's logits must agree."""
    import torch
    from umgen_tpu.config import ModelConfig
    from umgen_tpu.data.synthetic import make_token_batch
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.models.sampling import greedy_sample
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                  quantize_params_int8)
    cfg = ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                      tar_cache_dtype="bfloat16",
                      oar_cache_dtype="int8", fused_oar_kernel=True,
                      tar_cache_window=20).scaled(scale)
    model = UMGen(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = pack_fused(quantize_params_int8(init_params(cfg, g, dev)))

    def to_cpu(t):
        return ({k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict)
                else t.cpu())

    cond = make_token_batch(model.layout, T=2, B=1, seed=0, config=cfg)
    decisions = {"dev": [], "cpu": []}
    runs = {}
    for side, device, p in (("dev", dev, params), ("cpu", "cpu",
                                                   to_cpu(params))):
        ro = Rollout(model)
        if side == "dev":
            def sampler(gen, logits):
                tok = greedy_sample(gen, logits)
                decisions["dev"].append((logits.float().cpu(), tok.cpu()))
                return tok
        else:
            replay = iter(decisions["dev"])

            def sampler(gen, logits):
                decisions["cpu"].append((logits.float(), None))
                return next(replay)[1]
        ro._samplers = {m: sampler for m in ro._samplers}
        inputs = {m: torch.as_tensor(v, dtype=torch.long, device=device)
                  for m, v in cond.items()}
        t0 = time.perf_counter()
        out, _ = ro.frame_step_prefill(p, inputs, torch.Generator(device))
        runs[side] = {k: getattr(out, k).cpu() for k in
                      ("tokens", "ego_logits", "prior_seq")}
        runs[side]["seconds"] = time.perf_counter() - t0

    def rel(a, b):
        # over the finite entries (the control override masks <pad> with
        # -inf); the -inf entries must coincide
        a, b = a.float(), b.float()
        fin = torch.isfinite(b)
        if not torch.equal(fin, torch.isfinite(a)):
            return math.inf
        return ((a - b)[fin].abs().max() / b[fin].abs().max()).item()

    err_ego = rel(runs["cpu"]["ego_logits"], runs["dev"]["ego_logits"])
    err_pri = rel(runs["cpu"]["prior_seq"], runs["dev"]["prior_seq"])
    n = len(decisions["dev"])
    if len(decisions["cpu"]) != n:
        raise AssertionError(f"{n} decisions on the device, "
                             f"{len(decisions['cpu'])} on the CPU")
    errs = [rel(c[0], d[0]) for c, d in zip(decisions["cpu"],
                                           decisions["dev"])]
    worst = max(range(n), key=errs.__getitem__)
    same = torch.equal(runs["cpu"]["tokens"], runs["dev"]["tokens"])
    res = {"scale": scale, "decisions": n, "ego_logits_rel_err": err_ego,
           "priors_rel_err": err_pri, "logits_rel_err_max": errs[worst],
           "logits_rel_err_mean": sum(errs) / n, "tokens_equal": same,
           "device_s": runs["dev"]["seconds"], "cpu_s": runs["cpu"]["seconds"]}
    print(f"(d) {scale} scale, one prefill frame on {dev} vs the CPU: ego "
          f"logits rel err {err_ego:.3g}, priors {err_pri:.3g}, logits of "
          f"{n} decisions max {errs[worst]:.3g} (decision {worst}) mean "
          f"{res['logits_rel_err_mean']:.3g}; tokens equal: {same}")
    if not (same and err_ego <= REF_RTOL_PRIORS
            and err_pri <= REF_RTOL_PRIORS
            and errs[worst] <= REF_RTOL_LOGITS):
        raise AssertionError(f"the model on {dev} disagrees with the plain "
                             f"versions on the CPU: {res}")
    return res


def phase_rollout(dev, out_dir):
    import numpy as np
    from umgen_tpu.layout import CONTENT_LEN
    from umgen_tpu_torch.ops import decode_kernel as dk
    from umgen_tpu_torch.ops import flash_attention as fa
    from umgen_tpu_torch.tools import evaluate
    args = evaluate.build_parser().parse_args([
        "--infer_task", "video", "--model_scale", "larger", "--fused_oar",
        "--kv_dtype", "bfloat16", "--int8", "decode", "--debug",
        "--synthetic_data", "1", "--max_scenes", "1",
        "--set_num_new_frames", "3", "--batch_size", "1",
        "--sample_method", "topk", "--output_path", out_dir,
        "--device", str(dev)])
    for counts in (fa.LAUNCHES, dk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    runner, gen = evaluate.run(args)
    secs = time.perf_counter() - t0
    launches = {**fa.LAUNCHES, **dk.LAUNCHES}
    vocab = {"pose": 1024, "map": 8192, "bbox3d": 1028, "image": 8192}
    out = _load_tokens(out_dir)
    for mod, n in vocab.items():
        toks = np.asarray(out[mod])
        if toks.shape[-1] != CONTENT_LEN[mod] or toks.shape[1] != 23:
            raise AssertionError(f"{mod}: token shape {toks.shape}")
        if toks.min() < 0 or toks.max() >= n:
            raise AssertionError(f"{mod}: tokens outside [0, {n})")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} never launched on the main path")
    frame_s = list(gen.frame_seconds)
    print(f"(c) UMGen_Large cached rollout B=1: per-frame seconds "
          f"{', '.join(f'{s:.2f}' for s in frame_s)} (first = prefill + "
          f"decode); launches {launches}; whole run {secs:.1f} s")
    return {"frame_seconds": frame_s, "launches": launches,
            "seconds": secs}


def _load_tokens(out_dir):
    import pickle
    tok_dir = os.path.join(out_dir, "saved_token")
    [name] = os.listdir(tok_dir)
    with open(os.path.join(tok_dir, name), "rb") as f:
        return pickle.load(f)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import umgen_tpu_torch  # noqa: F401  (sets the TF32 switches)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    report["build"] = phase_build()
    report["flash"], flash_err, report["flash_planted"] = phase_flash(dev)
    report["decode"] = phase_decode(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        report["rollout"] = phase_rollout(dev, out_dir)
    torch.cuda.empty_cache()
    report["reference"] = phase_reference(dev)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    def pick(rows, **kw):
        return next(r for r in rows if all(r[k] == v for k, v in kw.items()))

    f1 = pick(report["flash"], B=1, Sq=2207, causal=False)
    v5 = pick(report["decode"]["v5"], B=1, cache_len=1100)
    mq = pick(report["decode"]["v5mq"], B=1, Q=6)
    launches = report["rollout"]["launches"]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "umgen_tpu_torch/csrc/flash_attention.cu",
         "replaces": "umgen_tpu/ops/flash_attention.py:79",
         "launches": launches["flash_attention"], "max_abs_err": flash_err,
         "ms": f1["ms"], "plain_ms": f1["plain_ms"]},
        {"name": "fused_decode_step_v5", "route": "cuda",
         "source": "umgen_tpu_torch/csrc/decode_step.cu",
         "replaces": "umgen_tpu/ops/decode_kernel.py:1363",
         "launches": launches["fused_decode_step_v5"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in report["decode"]["v5"]),
         "ms": v5["ms"], "plain_ms": v5["plain_ms"]},
        {"name": "fused_decode_step_v5mq", "route": "cuda",
         "source": "umgen_tpu_torch/csrc/decode_step.cu",
         "replaces": "umgen_tpu/ops/decode_kernel.py:3411",
         "launches": launches["fused_decode_step_v5mq"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in report["decode"]["v5mq"]),
         "ms": mq["ms"], "plain_ms": mq["plain_ms"]},
    ]
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
