"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases variants step_loops   # a partial run

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It imports nothing of JAX.  Phases:

  (a) build the port's CUDA kernels from umgen_tpu_torch/csrc/ (nvcc);
  (b) hold each of the fifteen kernels against its plain PyTorch version on
      the card, at the shapes the served configurations give it (B = 1, 2
      and 10 scenes; the int8, the int4 and the bf16 / fp8 OAR cache), and
      time both; hold the decode steps' prefix attention by itself, through
      a layer that returns x + the attention output, and check that wrong
      prefixes fail that (five int4 ones; for v1, v2 and v7 a bf16 cache
      read at fp8 precision, the scene's query scale in place of the
      head's, a dropped 32-row block); v3 and v4 must equal v5 bit for bit,
      v6's h too; time `scaled_dot_product_attention` beside the flash
      kernel, for the record only; `torch.profiler` tables
      (µs a call by kernel, the device's busy share, launches a layer) of
      20 w4 and 20 w4i4 steps at B = 10, of 20 v5, v2 and v1 steps at B = 1
      (v2, v1 on a bf16 cache), all at cache_len 1100, and of 20 flash calls
      at B·T = 10; v5 and v2 at B = 1 with the layer norm inside the int8
      products and by ln_quant_kernel, in turns, h equal bit for bit; the
      GELU kernel (`--phases gelu`) against the plain exact-erf GELU on
      every bf16 bit pattern and at [22070, 3072] and [44140, 3072] (the
      cascades' MLP activations of 10 scenes and of a 20-frame window), bit
      for bit, both timed, and the plain version's launches a call;
  (c) run the UMGen_Large cached video rollout (36-layer stacks, d = 768,
      seeded random weights on the card, one synthetic scene, B = 1, bf16
      rings, int8 decode weights) through the CLI's code path
      (umgen_tpu_torch.tools.evaluate), with every kernel's launch count
      reset just before: the prefill frame plus one cached frame.  Tokens
      must lie in their modalities' ranges, logits and priors must be
      finite, and flash, v5 and v5mq must have launched;
  (d) run one prefill frame of that configuration at full width with
      one-layer stacks on the card and, from the same weights, on the CPU
      (the plain versions), the CPU replaying the card's greedy decisions:
      tokens equal, ego logits, TAR priors and every decision's logits
      close.  The card's sides of (d), (n), (f) and (i) run after the B = 1
      and 2 paths (c, h, j, k, l); each CPU side runs in a child process
      while the card runs (e) and (g), and is compared at the end;
  (e) the JAX bench's serving configuration end to end: UMGen_Large, B = 10
      synthetic scenes, a 20-frame window ingested frame by frame (chunked
      prefill) into 8-frame int4 TAR rings, int8 weights on every stack,
      W4A8 OAR weights (runtime.quantize.pack_fused_w4), top-k, rule
      constraint on, through Generator / SceneRunner; one generated frame
      (the 19 ingests, a cached step; two until PR 9, cut for time).
      Flash, w4 and w4mq must launch, v5 and v5mq must not;
  (f) that configuration at debug scale (one layer a stack, full width),
      B = 2, a 2-frame ring under a 3-frame window, chunked prefill, on the
      card and on the CPU as in (d);
  (g) serving-i4, this slice's main path: the serving configuration of (e)
      with the OAR cache int4 (`--oar_kv_dtype int4`: nibble-packed rows,
      per-(row, head) scales), at full width and depth, one generated frame
      as (e).  Flash, w4i4 and w4mqi4 must launch; v5, v5mq, w4, w4mq, v5i4
      and v5mqi4 must not;
  (h) slice-i4: the configuration of (c) with the OAR cache int4, B = 1,
      the prefill frame.  Flash, v5i4 and v5mqi4 must launch, no other
      decode kernel;
  (i) serving-i4 at debug scale on the card and on the CPU, as (f) with one
      scene (the CPU side is most of the phase's time);
  (j) slice-bf16kv: the configuration of (c) with `--oar_kv_dtype
      bfloat16`, full width, the 24-layer depth (`--model_scale stander`,
      to keep the script inside its time), B = 1, the prefill frame (a
      cached one too until PR 9).  Flash and v2 must launch (2196 steps), no
      other decode kernel: the multi-row pushes run the eager body on the
      bf16 cache;
  (k) slice-v7: the configuration of (c) with `--oar_kernel 7`, B = 2, the
      24-layer depth, the prefill frame (a cached one too until PR 9).
      Flash, v7 and v5mq must launch, v5 must not;
  (l) slice-fp8kv (`--oar_kv_dtype float8_e4m3fn`, through the CLI's code
      path: flash and v2) and slice-v1 (int8-quantized but unpacked OAR
      weights on a bf16 cache, through Generator: flash and v1), each the
      prefill frame at full width and the 24-layer depth (`--model_scale
      stander`);
  (m) 64 single-token steps from cache_len 1000 at full width and depth,
      B = 2: `Rollout.oar_step` on caller-built 5-D int8 caches with the v3
      and then the v4 packing, and `fused_decode_step_v6`, each against v5
      on the same inputs (v3, v4: h and caches bit for bit at every step);
  (n) slice-bf16kv at debug scale on the card and on the CPU, as (d);
  (o) the reference CLI's default run through the CLI's code path with no
      flag but `--debug --synthetic_data 1 --max_scenes 1
      --set_num_new_frames 1 --save_video false` (every CLI phase passes
      `--save_video false`: the VQ decoders and the video are phase x's,
      so the CLI phases' times, tokens and launches stay as they were and
      none needs cv2), its TAR and OAR stacks cut to 3 layers
      (`DEFAULT_RUN_LAYERS`, to keep the script inside its time): full
      width, B = 1, 20-frame fp8 TAR rings,
      an fp8 OAR cache decoded by the reference's unfused body for all 2202
      positions, int8 decode weights, top-k.  Flash must launch and no
      decode kernel; prints the frame's time, the eager step's wall ms over
      steps 500-1499, the peak device memory, and a `torch.profiler` table
      of 20 eager steps at cache_len 1100 (`eager_profile`);
  (p) recompute (`--tar_mode recompute --fused_oar --kv_dtype bfloat16
      --sample_method greedy`), full width, the TAR / OAR stacks at
      DEFAULT_RUN_LAYERS (cut from 36 for the script's time), B = 1, two frames
      (the second one's window has slid): the whole 20-frame window through
      every TAR stack each frame.  Flash must launch twice a TAR-family
      block a frame (192 at 36 layers, 126 at 3), v5 and v5mq must launch;
      prints each frame's TAR / OAR split and the peak memory;
  (q) ring refresh on fp8 rings (`--fused_oar --tar_cache_refresh 1
      --sample_method greedy`, an int8 OAR cache), p's depth, two frames: the refresh
      must fire once (Generator.refreshes); flash, v5 and v5mq must launch.
      Prints the share of its second frame's tokens equal to (p)'s, for the
      record;
  (r) recompute, and the default unfused run, at debug scale (one layer a
      stack, full width), B = 1, on the card and on the CPU, as (d).
  (s) the control task (`--infer_task control --fused_oar --kv_dtype
      bfloat16 --int8 decode --sample_method greedy`) at UMGen_Large width
      and depth through the CLI's code path, cut to 2 generated frames (the
      task's 30 are fixed by InferConfig, as the reference's), B = 1, one
      synthetic control pkl (13 conditioning frames, the ego trajectory, one
      controlled agent, a 2-frame GT continuation) under the working
      directory's data/controlled_scenes, on a checkpoint: seeded weights
      exported in the reference's format and read back by `--ckpt_dir`.
      The pose tokens must be the trajectory, flash, v5 and v5mq must
      launch and no other decode kernel, the collision rate and MMD must be
      finite, and `SceneRunner.run_scene` on the weights in memory must give
      the same tokens; prints the save and load seconds, each frame's OAR
      seconds and the rest, the peak memory and the launches;
  (t) `Generator.generate` at debug scale, B = 1, 2 frames after a 2-frame
      window with map and image forced, on the card and on the CPU, as (d):
      agent control (trajectory and three agents' boxes under
      `control_test`) in cached and in recompute mode, and the video task's
      `--init_token_mod map,image` replay;
  (u) speculative decoding (`--speculative_k 8 --sample_method greedy`
      with the flags of (c)), UMGen_Large width, the TAR / OAR stacks at
      DEFAULT_RUN_LAYERS (cut from 36 for the script's time), B = 1, the prefill
      frame and a cached one: every verify chunk one v5mq launch at Q = 8 (launches =
      chunks + 3 pushes a frame), no other decode kernel; then the same run
      without speculation, against whose stream every run of differing
      positions of the prefill frame must start at a near tie
      (SPEC_GAP_ULPS_36); prints the frame times, chunks, accepted drafts
      and the share of equal tokens;
  (v) W4 TAR weights on int2 rings (`--tar_w4 --kv_dtype int2
      --fused_oar`), UMGen_Large, B = 2, the full-window prefill and a
      cached frame: flash, v5 and v5mq launch; prints the frame times, the
      peak memory and the TAR-family weights' and rings' bytes (every CLI
      phase prints these);
  (w) at debug scale, card against CPU as (d), map and image forced:
      speculation on the serving configuration (w4mq verify chunks, B = 2)
      and on the int4 OAR cache (w4mqi4, B = 1), W4 TAR weights on int2
      rings (two frames: the full-window prefill, a cached frame), and the
      relative temporal PE (a seeded nonzero `tpe_rel`): a cached frame
      after a chunked window and a recompute frame; the card's run must
      launch the named decode kernels.  Phase b holds every mq kernel at Q
      = 8, the speculative chunk, on the views the chunks read (K slack
      rows past a segment's end);
  (x) the map and image VQ detokenizers (models.vq: MapDecoder at MAP_VQ,
      ImageDecoder at IMAGE_VQ, seeded weights) on the card, on a
      synthetic scene's 21 frames of phase c's layout:
      `SceneRunner._postprocess` with the scene as its own GT (the token
      pickle, the decode, the metrics and, where cv2 imports, the pred | GT
      mp4, whose GT maps are decoded too; its frame count must be 21), then
      `decode_tokens` alone: maps (21, 256, 256, 3) within [-1, 1], images
      (21, 256, 512, 3), finite, no `undecoded_token.txt`, none of the
      fifteen kernels launched.  Prints each decoder's ms a frame at its
      chunk of 20 (CUDA events) beside its bound (the FLOPs a frame over
      the float32 peak) and the peak memory; the first two frames are
      decoded on the CPU in a child process, as (d), and must agree within
      VQ_ATOL.  The decoders are XLA convolutions in the JAX package, not a
      Pallas kernel: cuDNN's float32 convolutions here, TF32 off;
  (y) training (`--phases train`; the JAX trainer runs XLA attention and no
      Pallas kernel has a backward, so none of the fifteen may launch):
      UMGen_Large, seeded bf16 weights, use_pallas_attention=False, remat,
      AdamW at lr 3e-4 warming up over 1 of 10 steps, B = 1, a 4-frame
      window of one synthetic scene, three steps on that batch — the loss
      and grad norm finite at each, the third step's loss below the
      first's; prints each step's seconds (CUDA events, host clock), the
      peak device memory, the TFLOP of a step and the rate, and a
      `torch.profiler` table of a fourth step (`train.profile`).  Then one AdamW
      step at the tiny scale in float32, card against a CPU child process
      (TRAIN_*), a checkpoint round trip at debug scale (the next step from
      the loaded state and from the one in memory equal bit for bit), and
      three Adam steps of the map VQ codec at MAP_VQ's size, B = 2, decoded
      by MapDecoder from its save;
  (z) data parallelism and the profiler (`--phases dp`): (z1) `--dp 2`
      through the ranks the CLI starts (parallel.mesh.launch →
      evaluate.rank_main), two ranks sharing the one card over gloo, phase
      c's flags with `--sample_method greedy` at UMGen_Large width, the TAR
      / OAR stacks cut to DEFAULT_RUN_LAYERS, B = 2 synthetic scenes (one a
      rank), the prefill frame and a cached one: flash, v5 and v5mq must
      launch in each rank and no other decode kernel, tokens in range, each
      scene's tokens equal bit for bit to a one-process B = 1 run of it on
      the same seeded weights, the collision rate and MMD finite; (z2) the
      same path at world size 1 over NCCL, tokens equal to the one-process
      run's; (z3) `--profile_dir` on a debug-scale CLI run (full width, one
      layer a stack, the prefill frame): the trace must name the flash and
      decode-step kernels, its size printed; (z4) in z1's ranks: one AdamW
      step of the tiny float32 trainer on a global batch of 2 (params and
      moments equal across the ranks bit for bit, within TRAIN_* of the
      one-process step on the whole batch) and one Adam step of the map VQ
      codec at MAP_VQ, global B = 2 (codebook, params and Adam state equal
      across the ranks).  Prints each rank's frame times beside the
      one-process run's, and which gloo collectives take CUDA tensors (the
      mesh reaches gloo through host copies).  The reference, z1 and z4 run
      after phase l, on a quiet host; z2 and z3 after the serving paths,
      while the CPU sides of the card-against-CPU phases finish;
  (tp) tensor parallelism (`--phases tp`), after z2 and z3: two ranks at
      tp = 2 sharing the card over gloo.  (tp1) the GSPMD-mode Generator
      (`Generator(model, mesh.shard_params(params), mesh=mesh)`) on phase
      c's flags, greedy, UMGen_Large width (8 of 16 heads a rank), every
      stack at TP_LAYERS, a TP_WINDOW-frame window, B = 1, the prefill frame
      and a cached one: flash on the rank's heads, v5 and v5mq on the whole
      OAR (decode packs keep it whole) must launch in each rank and no other
      decode kernel; the ranks' tokens equal, and against a one-process run
      on the same weights equal or every differing run starting at a near
      tie (<= TP_GAP_ULPS bf16 ulps), the cached frame against a run
      teacher-forced to rank 0's prefill frame.  (tp2) one bf16 AdamW step of that
      model at tp = 2 against one process (TP_BF16_*) and the tiny float32
      step (TRAIN_*); the replicated leaves and moments equal across the
      ranks bit for bit;

Prints each phase's results, the card's name and power limit, a JSON line
describing the kernels, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure exits non-zero without that line.  Details land in
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
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
# decode step: exact int8 products on both sides (W4A8: exact per group,
#   the group scales applied in float32 in the plain version's order), and
#   the kernel (built with --fmad=false) rounds where the plain version
#   does.  The prefix attention's float32 sums inside an S-block (Σ p, the
#   value sums) run in PyTorch's order in the plain version and in another
#   in the kernel, which can flip an int8 re-quantization of the attention
#   output at a near tie: one layer's h within a few bf16 ulps (2^-8 of its
#   scale); through 36 layers of random weights the flips compound
#   (measured on an H100: 0.5% at 1 layer, 2.5% at 8, 7.5% at 36 with
#   +-6.25 random caches), so the 36-layer bound only catches gross faults.
#   New K/V rows of layer 0 see identical inputs: equal up to one grid step
#   at rounding ties (int4: nibbles and scales equal, as the prep pass
#   quantizes a new row exactly as `quantize_kv_int4` does, IEEE 7/s then a
#   product).  At cache_len 0 there is no prefix, and the plain step sums
#   its layer norms and the chunk's own attention in the kernel's order: h
#   and every layer's new rows (int4: nibbles and scales) bit for bit at any
#   B and Q, which pins each layer's weight, vector and cache offsets.
#   The prefix attention itself (every kernel, every case with a prefix):
#   through a layer of random weights the attention is ~0.6% of max |h|, so
#   the bounds on h above cannot see a wrong prefix attention.  It is read
#   through layer 0 with the output projection the identity and the MLP's
#   second product zero, on x scaled by 2^-6: h - x is then the attention
#   output y (after its int8 quantization for the projection).  On both
#   integer caches the kernel walks the plain version's S-blocks and keeps
#   each of its rounding points (int4: each weight bf16(p·vs·(1/7)) from its
#   S-block's p, against that block's running maximum); only the float32
#   sums inside a block run in another order, so y's int8 quantization
#   flips at near ties only (tests/test_torch_cuda.py::
#   test_w4mq_flip_is_a_near_tie pins one).  Bounds: no element further
#   than one int8 step and two bf16 ulps of the largest, 2e-2 of max |y|,
#   and a mean error within 2^-10 of the mean |y| for phase b's first half
#   (v5, v5mq, w4, w4mq and the int4-cache steps v5i4, w4i4, v5mqi4,
#   w4mqi4) and for v1 and v2, 2^-7 for v7.  The phase also checks that the
#   looser bounds reject five planted int4 faults, made through the plain
#   version's inputs at cache_len 1100: the K and V scale planes swapped,
#   the low nibble read for the heads >= H/2, a dropped 32-row block, and
#   the V or the K nibbles one grid step high (an eighth of an omitted -8
#   bias).
#   The six steps added last (phase b's second half).  v3, v4, v6, v7 keep
#   integer logits and the bounds above, cache_len 0 bit for bit through 36
#   layers; v3 and v4 launch v5's kernel on the flat view of their 5-D
#   caches, so on the same values they must equal v5 bit for bit at every
#   cache_len (h and rows); v6's h must equal v5's and its new rows (from
#   float32) lie at most one grid step from v5's and equal the plain
#   version's at layer 0.  v1 and v2 (a dense bf16 / fp8 / int8-grid cache
#   read as bf16) run on the S-block passes of the integer caches: the
#   kernel keeps the plain version's S-blocks and every rounding point of it
#   (bf16(w·v) for each product, bf16 for the block sum, the rescale and the
#   denominator), and differs in the order of the float32 sums inside a
#   block only; at cache_len 0 the attention is the new row's own value:
#   bit for bit, h and rows in the cache's type; layer 0's rows equal at
#   every cache_len.  The prefix attention by itself for v1, v2 and v7:
#   v1 and v2 held to 2^-10 of the mean |y| as the first half, v7 to 2^-7;
#   planted faults at cache_len 1100 must fail the looser bounds (2^-7):
#   the bf16 cache read at fp8 precision (v1, v2 on bf16), the scene's
#   query scale in place of the (scene, head) one (v7), a dropped 32-row
#   block (all).
DECODE_RTOL_1 = 2e-2
DECODE_RTOL_36 = 0.15
KV_LAYER0_ATOL = 1
ATTN_RTOL_MAX = 2e-2
ATTN_RTOL_MEAN = 2.0 ** -7
ATTN_RTOL_MEAN_SBLOCKS = 2.0 ** -10
# the model on the card against the plain versions on the CPU (phase d,
#   one layer per stack at full width): ego logits and TAR priors are bf16
#   outputs of the same ops, where the flash kernel and cuBLAS round and sum
#   in another order than the CPU — a few bf16 ulps per stack, four stacks
#   deep; a decision's logits sit behind one decode-step layer (<= 2e-2 of
#   its scale, above) and a bf16 head.  Relative to each tensor's max |.|.
REF_RTOL_PRIORS = 2e-2
REF_RTOL_LOGITS = 5e-2
# phase f, the serving configuration at debug scale, card against CPU: as
#   phase d, plus int4 rings.  A ring value is quantized per (scene, frame,
#   head) to a grid of 1/7 of the group's max |.|; a K/V value that differs
#   by a bf16 ulp between the two devices lands one grid step apart in
#   ~1% of the ring, which moves that frame's logits and values by up to
#   a step — so the bounds are wider than phase d's.  W4A8 adds no error
#   beyond W8A8's between the two devices (exact integer products).
#   Phase i (the int4 OAR cache) keeps these bounds: the OAR cache does not
#   reach the priors, and a cached OAR row one int4 step apart between the
#   devices is one key of up to 2200 under the softmax.
SERVE_RTOL_PRIORS = 5e-2
SERVE_RTOL_LOGITS = 1e-1
# phase r (recompute; the default unfused run on fp8 rings and an fp8 OAR
#   cache) keeps phase d's bounds: recompute is phase d's prefill pass
#   without the rings, and the prefill frame reads no ring; the eager body
#   rounds as the decode step's plain version, and an fp8 row one step
#   apart between the devices is one key of up to 2200 under the softmax.

# phase x, the VQ decoders on the card against the CPU, 2 frames in one
#   chunk: float32 products on both sides (TF32 off), cuDNN's convolution
#   algorithms against oneDNN's, so sums in other orders through ~30 convs
#   of random weights, each behind a group norm that keeps the activations
#   O(1).  Bound on the largest absolute difference of the maps (to_rgb, in
#   [-1, 1]) and of the images (the decoder's output, |x| of a few units):
#   1e-4, set from the first reading on an H100 (maps 5.84e-6, images
#   1.74e-5 of |x| <= 2.78) with room for other cuDNN algorithms.
VQ_ATOL = 1e-4
VQ_FRAMES = 21
# a frame's picture from each decoder
VQ_PICTURES = {"map": (256, 256, 3), "image": (256, 512, 3)}

# phase y, training.  The full-width run: a 4-frame window (3 slots for the
#   ego and TAR losses, the last frame for the OAR's), B = 1.  The tiny
#   float32 step on the card against the CPU (TF32 off): the loss terms are
#   sums of the same float32 ops in other orders, 1e-5 relative (the CPU
#   tests hold the port to JAX at that bound, first reading ~1e-7); each
#   gradient leaf within 1e-4 relative L2 (as the CPU tests hold it to
#   JAX's), read from the first Adam moment mu = 0.1·g; the params after
#   the step within 1e-5: the trainer's first step is its warmup (lr 0), so
#   they stay where they were on both devices, and Adam's state carries
#   the step.  (An Adam move proper is g / (|g| + 1e-8), which roundoff
#   steers wherever |g| is near 1e-8: tests/test_torch_train_steps.py
#   holds two steps against JAX with that rule.)
TRAIN_WINDOW = 4
TRAIN_PROFILE_TOP = 15
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, int8 OP/s, float32 FLOP/s outside the tensor
# cores — the yardsticks of `bound_ms`
H100_BYTES_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_FP32_FLOPS = 67e12
# float32 instructions a second outside the tensor cores: 132 SMs x 128
# lanes x 1.98 GHz, the FLOP/s above with a fused multiply-add counted once
H100_FP32_INSTR_S = H100_FP32_FLOPS / 2


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


def _kernel_profile(fn, calls: int) -> dict:
    """`torch.profiler` over `calls` calls of fn, warm: device µs a call by
    kernel name (the table's self CUDA time over the launches) and the
    device's busy share, the kernels' time over the host clock of the
    window (as tools/profile_frame.py reads it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = {e.key: {"launches_per_call": e.count / calls,
                     "us_per_launch": e.self_device_time_total / e.count,
                     "us_per_call": e.self_device_time_total / calls}
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.count}
    device_us = sum(r["us_per_call"] for r in table.values()) * calls
    return {"calls": calls, "wall_ms": 1e3 * wall,
            "device_ms": device_us / 1e3,
            "busy": device_us / (1e6 * wall),
            "kernels": dict(sorted(table.items(),
                                   key=lambda kv: -kv[1]["us_per_call"]))}


def _print_profile(what, prof):
    print(f"(b) profile of {prof['calls']} {what}: {prof['device_ms']:.3f} "
          f"device ms in {prof['wall_ms']:.3f} ms (busy "
          f"{100 * prof['busy']:.1f}%); µs a call (launches a call, µs a "
          "launch):")
    for name, r in prof["kernels"].items():
        print(f"      {r['us_per_call']:9.2f}  ({r['launches_per_call']:g}, "
              f"{r['us_per_launch']:.2f})  {name[:90]}")


def _step_profile(fn, L, what) -> dict:
    """`_kernel_profile` of 20 decode steps of L layers, printed, with the
    kernels a layer: a step launches two besides its layers' (the residual
    stream in and out)."""
    prof = _kernel_profile(fn, 20)
    per_step = sum(r["launches_per_call"] for r in prof["kernels"].values())
    prof["launches_per_layer"] = (per_step - 2) / L
    _print_profile(what, prof)
    print(f"(b) {what}: {prof['launches_per_layer']:g} launches a layer")
    return prof


def _bound(nbytes: float, ops_s: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and `ops_s`, its operations over the peak rate of
    their type, in seconds."""
    byte_s = nbytes / H100_BYTES_S
    return {"bound_ms": 1e3 * max(byte_s, ops_s),
            "bound_by": "bytes" if byte_s >= ops_s else "operations"}


def flash_work(B, Sq, Sk, causal, H=16, Dh=48):
    """(bytes, seconds of operations at the bf16 peak) of one attention
    call: q, k, v read and o written in bf16; QKᵀ and PV at 2 FLOPs a
    multiply-add, over the keys a causal query sees."""
    nbytes = 2 * B * H * Dh * (2 * Sq + 2 * Sk)
    pairs = Sq * Sk - (Sq * (Sq - 1) // 2 if causal else 0)
    return nbytes, 4 * B * H * pairs * Dh / H100_BF16_FLOPS


def decode_work(name, L, d, H, B, Q, cl, kv="int8"):
    """(bytes, seconds of operations) of one decode step: every layer's
    weights and vector block, the cl cached rows of K and V per scene (int8
    and fp8: d bytes a row; bf16: 2d; int4: d/2 bytes + H float32 scales),
    the Q new rows written, x read and h written; the four products as int8
    operations, the attention's QKᵀ as int8 and its PV as bf16 ones (v1 and
    v2, which read their cache as bf16: both as bf16)."""
    w4, i4 = name.startswith("w4"), name.endswith("i4")
    dense = name in ("v1", "v2")
    weights = 6 * d * d + 12 * d * (d // 128) * 4 if w4 else 12 * d * d
    row = 2 * (d // 2 + 4 * H) if i4 else 4 * d if kv == "bfloat16" else 2 * d
    nbytes = L * (weights + 15 * d * 4 + B * (cl + Q) * row) + 4 * B * Q * d
    keys = cl + (Q + 1) / 2            # prefix + the causal chunk, per query
    qk_rate = H100_BF16_FLOPS if dense else H100_INT8_OPS
    ops_s = L * B * Q * (2 * 12 * d * d / H100_INT8_OPS
                         + 2 * keys * d / qk_rate
                         + 2 * keys * d / H100_BF16_FLOPS)
    return nbytes, ops_s


# the float32 operations of one GELU element on the erfc branch it takes
# (modules._erfc_f32): z = -x·c, z², 0.5·x and the product on every branch;
# |z| < 1 a 7-term Horner in z² (12), z·p, 1 - (14); [1, 2) 1/z², a 9-term
# Horner (16), exp, 1/|z|, two products, the underflow test, the reflection
# (23); >= 2 an 8-term Horner (21)
GELU_OPS = (4 + 14, 4 + 23, 4 + 21)
# [B·S, 3072]: the MLP activation of one cascade block at 10 scenes, and of
# the recompute window's 20 frames, at 2207 positions
GELU_SHAPES = ((22070, 3072), (44140, 3072))


def gelu_work(x):
    """(bytes, seconds of operations at the float32 issue rate) of one GELU
    of x: 2 bytes read and 2 written an element; the float32 operations of
    the branch each element of x takes."""
    az = x.float().abs() * 0.70703125
    small = int((az < 1).sum())
    mid = int(((az >= 1) & (az < 2)).sum())
    ops = (GELU_OPS[0] * small + GELU_OPS[1] * mid
           + GELU_OPS[2] * (x.numel() - small - mid))
    return 4 * x.numel(), ops / H100_FP32_INSTR_S


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
    cases = [  # (B, Sq, Sk, causal): prefill window, one frame of 10 scenes
        (20, 2207, 2207, False), (10, 2207, 2207, False),  # (serving), of
        (1, 2207, 2207, False), (2, 2207, 2207, False),    # 1 and 2, map
        (1, 1031, 1031, False), (1, 1031, 2207, True)]     # stack, causal
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
        if (B, Sq, causal) == (10, 2207, False):
            profile = _kernel_profile(
                lambda: fa.flash_attention(q, k, v, causal), 20)
            _print_profile("flash calls, B·T = 10, S = 2207", profile)
        pms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                       max(1, reps // 4), warmup=1)
        # the one PyTorch call that computes the same function; timed for
        # the record, used nowhere in the port ([B, H, S, Dh] views; the
        # causal mask bottom-right aligned, as the kernel's)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
                .tril(Sk - Sq) if causal else None)
        lib_ms = _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), reps)
        rows.append({"B": B, "Sq": Sq, "Sk": Sk, "causal": causal,
                     "max_abs_err": err, "rel_err_max": errs[0],
                     "rel_err_mean": errs[1], "ms": ms, "plain_ms": pms,
                     "library_ms": lib_ms,
                     **_bound(*flash_work(B, Sq, Sk, causal))})
        print(f"(b) flash B={B} Sq={Sq} Sk={Sk} causal={causal}: max abs "
              f"err {err:.3g} ({errs[0]:.3g} of max |ref|, mean "
              f"{errs[1]:.3g} of mean |ref|), kernel {ms:.3f} ms, plain "
              f"{pms:.3f} ms, scaled_dot_product_attention {lib_ms:.3f} ms, "
              f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})")
    print("(b) flash check against planted faults (max, mean; each must "
          "fail): " + ", ".join(f"{k} {e[0]:.3g} / {e[1]:.3g}"
                               for k, e in planted.items()))
    return rows, worst, planted, profile


def gelu_mismatches(got, ref) -> int:
    """Elements whose bits differ, a NaN equal to a NaN."""
    import torch
    nan = ref.isnan()
    return int((got.isnan() != nan).sum()) + int(
        (got.view(torch.int16)[~nan] != ref.view(torch.int16)[~nan]).sum())


def gelu_max_err(got, ref) -> float:
    """The largest |got - ref| where ref is finite (0.0 when bit for
    bit)."""
    fin = ref.isfinite()
    return float((got.float()[fin] - ref.float()[fin]).abs().max())


def phase_gelu(dev):
    """The GELU kernel against the plain version on the card, bit for bit:
    every bf16 bit pattern, then unit-normal activations at GELU_SHAPES,
    each timed beside the plain version and `F.gelu` (for the record)."""
    import torch
    from umgen_tpu_torch.models import modules as nn
    from umgen_tpu_torch.ops import gelu as gk
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                     device=dev).to(torch.int16).view(torch.bfloat16)
    got, ref = gk.gelu(x), nn._gelu_plain(x)
    every = gelu_mismatches(got, ref)
    err = gelu_max_err(got, ref)
    print(f"(b) gelu on all 65536 bf16 inputs: {every} elements differ from "
          f"the plain version (max abs err {err})")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = []
    for shape in GELU_SHAPES:
        x = torch.randn(*shape, generator=g, device=dev).bfloat16()
        got, ref = gk.gelu(x), nn._gelu_plain(x)
        bad = gelu_mismatches(got, ref)
        err = max(err, gelu_max_err(got, ref))
        del got, ref
        ms = _time_ms(lambda: gk.gelu(x), 50)
        pms = _time_ms(lambda: nn._gelu_plain(x), 5, warmup=1)
        lib_ms = _time_ms(lambda: torch.nn.functional.gelu(x), 50)
        prof = _kernel_profile(lambda: nn._gelu_plain(x), 2)
        plain_launches = sum(r["launches_per_call"]
                             for r in prof["kernels"].values())
        rows.append({"shape": list(shape), "mismatches": bad, "ms": ms,
                     "plain_ms": pms, "library_ms": lib_ms,
                     "plain_launches": plain_launches,
                     **_bound(*gelu_work(x))})
        print(f"(b) gelu {list(shape)}: {bad} elements differ; kernel "
              f"{ms:.4f} ms, plain {pms:.3f} ms ({plain_launches:g} "
              f"launches), F.gelu {lib_ms:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})")
    if every or any(r["mismatches"] for r in rows):
        raise AssertionError("the GELU kernel differs from the plain version")
    return {"every_bf16": every, "max_abs_err": err, "rows": rows}


def _first_layer(tree):
    """Layer 0 of a stacked tree, as a stack of one layer."""
    return ({k: _first_layer(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree[:1].clone())


def _decode_params(dev):
    """One random 36-layer OAR stack at the model's width and its packings:
    {"v5": int8 (pack_decode_weights), "w4": W4A8 (pack_fused_w4), "v4": the
    six int8 streams (pack_fused_oar_v4), "qoar": the int8-quantized stack
    unpacked (what v1 takes)};
    and its layer 0 made to show its attention, packed the same ways: the
    output projection the identity without bias, the MLP's second product
    zero, so that the layer returns x + the attention output."""
    import torch
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.params import _Init
    from umgen_tpu_torch.runtime.quantize import (pack_decode_weights,
                                                  pack_fused_oar_v4,
                                                  pack_fused_w4,
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
    vis = _first_layer(oar)
    proj = vis["attn"]["proj"]
    proj["w"] = torch.eye(cfg.n_embd, device=dev, dtype=proj["w"].dtype)[None]
    proj["b"] = torch.zeros_like(proj["b"])
    vis["mlp"]["proj"]["w"] = torch.zeros_like(vis["mlp"]["proj"]["w"])

    def packs(tree):
        q = quantize_params_int8({"oar": tree})
        return {"v5": pack_decode_weights(q["oar"]),
                "w4": pack_fused_w4({}, tree)["oar_packed"],
                "v4": pack_fused_oar_v4(q["oar"]), "qoar": q["oar"]}

    return cfg, packs(oar), packs(vis)


# (kernel, B, Q, cache_len): the bf16-ring slice's shapes (B = 1, 2), the
# serving configuration's (B = 10: Q = 6 pose prefill, Q = 2 segment
# pushes, Q = 1 steps), at an empty, a half-full and a full cache; v5 at
# B = 10 also half-full, beside w4 at the serving shape; 6-row chunks that
# end on an S-block's last row (552, 1104, 2208).  The int4-cache kernels
# at both configurations' shapes, at cache lengths on either side of the
# first S-block edge (552 rows at S = 2208).  Speculative verify chunks
# (Q = 8, the widest chunk the entry admits: Q·H = 128) of every mq kernel
# at B = 1 and 10 on the segment views they read: the bbox segment's (S =
# 1693 + 8 slack rows, cache_len 1100) and the image segment's (S = 2207 +
# 8, cache_len 2205, its last chunk: 8 rows written past the segment's end).
VERIFY_S = {1100: 1701, 2205: 2215}
DECODE_CASES = (
    [("v5", B, 1, cl) for B in (1, 2) for cl in (0, 1100, 2206)]
    + [("v5", 10, 1, 0), ("v5", 10, 1, 1100)]
    + [("v5mq", 1, 6, 0), ("v5mq", 2, 6, 0), ("v5mq", 1, 2, 1030),
       ("v5mq", 2, 2, 2205), ("v5mq", 10, 6, 0)]
    + [("v5mq", 1, 6, cl) for cl in (546, 1098, 2202)]
    + [("w4", B, 1, cl) for B in (1, 10) for cl in (0, 1100, 2207)]
    + [("w4mq", B, Q, cl) for B in (1, 10) for Q in (2, 6)
       for cl in (0, 1100, 2208 - Q)]
    + [("w4mq", B, 6, cl) for B in (1, 10) for cl in (546, 1098)]
    + [(f"{k}i4", B, 1, cl) for k in ("v5", "w4") for B in (1, 10)
       for cl in (0, 1100, 2207)]
    + [(f"{k}i4", B, 1, cl) for k, B in (("v5", 1), ("w4", 10))
       for cl in (551, 552, 553)]
    + [(f"{k}mqi4", B, Q, cl) for k in ("v5", "w4") for B in (1, 10)
       for Q in (2, 6) for cl in (0, 1100, 2208 - Q)]
    + [(f"{k}mqi4", B, 6, 546) for k, B in (("v5", 1), ("w4", 10))]
    + [(k, B, 8, cl) for k in ("v5mq", "w4mq", "v5mqi4", "w4mqi4")
       for B in (1, 10) for cl in VERIFY_S])


def _random_cache(g, dev, int4, L, B, S, d, H):
    """[kv_k, kv_v] int8 in ±100 (±6.25 on the 1/16 grid), or the int4
    cache [kv_k, kv_v, k_scale, v_scale]: nibbles in ±7 (-8 never occurs),
    scales in [0.5, 3.5)."""
    import torch
    if not int4:
        return list(torch.randint(-100, 101, (2, L, B, S, d), generator=g,
                                  device=dev, dtype=torch.int8))
    packed = []
    for _ in range(2):
        lo, hi = torch.randint(-7, 8, (2, L, B, S, d // 2), generator=g,
                               device=dev, dtype=torch.int8)
        packed.append((hi << 4) | (lo & 0xF))
    sc = 0.5 + 3 * torch.rand(2, L, B, S, H, generator=g, device=dev)
    return packed + [sc[0], sc[1]]


def _new_row_err(got, ref, int4, rows):
    """Largest difference between the rows `rows` of two cache tensors, per
    layer [L]: int8 values or int4 nibbles in grid steps, scales absolute."""
    from umgen_tpu_torch.ops.decode_kernel import unpack_kv_int4
    a, b = got[:, :, rows], ref[:, :, rows]
    if a.dtype.is_floating_point:
        d = (a - b).abs()
    elif int4:
        d = (unpack_kv_int4(a) - unpack_kv_int4(b)).abs()
    else:
        d = (a.int() - b.int()).abs()
    return d.amax(dim=(1, 2, 3)).float()


def attn_ok(errs, mean=ATTN_RTOL_MEAN) -> bool:
    return (all(math.isfinite(e) for e in errs)
            and errs[0] <= ATTN_RTOL_MAX and errs[1] <= mean)


def attention_summary(rows):
    """The prefix attention read by itself, per kernel over its cases with
    a prefix: the largest max and mean errors (of max |y|, of mean |y|) and
    how many cases are not bit for bit.  The kernel keeps the reference's
    S-blocks and every rounding point, so these sit far below the bounds
    (ATTN_RTOL_MAX, and ATTN_RTOL_MEAN_SBLOCKS for phase b's first half
    and for v1 and v2, ATTN_RTOL_MEAN for v7)."""
    out = {}
    for name, cases in rows.items():
        seen = [c for c in cases if c["attn_read"]]
        if seen:
            out[name] = {"max": max(c["attn_rel_err_max"] for c in seen),
                         "mean": max(c["attn_rel_err_mean"] for c in seen),
                         "cases": len(seen),
                         "cases_not_bit_equal": sum(
                             c["attn_rel_err_max"] > 0 for c in seen)}
    if out:
        print("(b) prefix attention by itself, worst max / mean error over "
              "the cases with a prefix, cases not bit for bit: "
              + ", ".join(f"{k} {v['max']:.3g} / {v['mean']:.3g} "
                          f"({v['cases_not_bit_equal']} of {v['cases']})"
                          for k, v in out.items()))
    return out


def planted_i4_faults(cache, cl):
    """Wrong int4 prefixes for the plain version, as {name: (cache,
    cache_len)}, from the one-layer cache [kv_k, kv_v, k_scale, v_scale]."""
    import torch
    from umgen_tpu_torch.ops.decode_kernel import unpack_kv_int4
    kp, vp, ks, vs = cache

    def low_twice(t):          # the low nibble in the high nibble's place
        return (t << 4) | (t & 0xF)

    def step_up(t):
        q = torch.clamp(unpack_kv_int4(t) + 1, max=7)
        lo, hi = q.split(q.shape[-1] // 2, dim=-1)
        return ((hi << 4) | (lo & 0xF)).to(torch.int8)

    def drop(t, a=512, n=32):  # rows [a, a + n) gone, the row count kept
        return torch.cat([t[:, :, :a], t[:, :, a + n:], t[:, :, :n]], dim=2)

    return {"k_v_scales_swapped": ([kp, vp, vs, ks], cl),
            "low_nibble_for_high_heads": ([low_twice(kp), low_twice(vp),
                                           ks, vs], cl),
            "dropped_32_row_block": ([drop(t) for t in cache], cl - 32),
            "v_nibbles_one_step_high": ([kp, step_up(vp), ks, vs], cl),
            "k_nibbles_one_step_high": ([step_up(kp), vp, ks, vs], cl)}


def phase_decode(dev, cfg, packs, visible):
    import torch
    from umgen_tpu_torch.ops import decode_kernel as dk
    L, d, H = cfg.n_oar_layer, cfg.n_embd, cfg.n_head
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    rows, profiles = {}, {}
    for name, B, Q, cl in DECODE_CASES:
        S = VERIFY_S[cl] if Q == 8 else 2208
        int4 = name.endswith("i4")
        packing = "w4" if name.startswith("w4") else "v5"
        packed, vis = packs[packing], visible[packing]
        cache = _random_cache(g, dev, int4, L, B, S, d, H)
        x = torch.randn(B, Q, d, generator=g, device=dev).to(torch.bfloat16)
        ck = [t.clone() for t in cache]       # the kernel's caches
        cp = cache                            # the plain version's
        fn = getattr(dk, f"fused_decode_step_{name}")

        def plain(pk, c, xin=x, at=cl):
            return dk.decode_step_plain(pk, xin, c[0], c[1], at, H, *c[2:])

        def layer0(c):
            return [t[:1].clone() for t in c]

        # the prefix attention itself: h - x of the layer that shows it
        attn, faults = (0.0, 0.0, 0), {}
        if cl:
            xs = (x.float() * 2.0 ** -6).to(torch.bfloat16)

            def readings(ref):
                d, r = (y - ref).abs(), ref.abs()
                return ((d.max() / r.max()).item(),
                        (d.mean() / r.mean()).item(), int((d > 0).sum()))

            y = fn(vis, xs, *layer0(ck), cl, n_head=H)[0].float() - xs.float()
            attn = readings(plain(vis, layer0(cp), xs).float() - xs.float())
            if int4 and cl == 1100:
                faults = {k: readings(plain(vis, c, xs, at).float()
                                      - xs.float())[:2]
                          for k, (c, at) in
                          planted_i4_faults(layer0(cp), cl).items()}
            passed = [k for k, e in faults.items() if attn_ok(e)]
            if not attn_ok(attn[:2], ATTN_RTOL_MEAN_SBLOCKS) or passed:
                raise AssertionError(
                    f"{name} B={B} Q={Q} cache_len={cl}: attention output "
                    f"max err {attn[0]:.3g} of max |y| (bound "
                    f"{ATTN_RTOL_MAX:.3g}), mean {attn[1]:.3g} of mean |y| "
                    f"(bound {ATTN_RTOL_MEAN_SBLOCKS:.3g}); planted faults "
                    f"that pass: {passed} of {faults}")

        one = {k: v[:1] for k, v in packed.items()}
        h1 = fn(one, x, *(t[:1].clone() for t in ck), cl, n_head=H)[0]
        h1ref = plain(one, [t[:1].clone() for t in cp])
        h = fn(packed, x, *ck, cl, n_head=H)[0]
        torch.cuda.synchronize()
        # the plain step is no yardstick of speed: the run that gives the
        # reference, after its one-layer run, timed once
        t0 = time.perf_counter()
        href = plain(packed, cp)
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
        rel1 = ((h1.float() - h1ref.float()).abs().max()
                / h1ref.float().abs().max()).item()
        err = (h.float() - href.float()).abs().max().item()
        rel = err / href.float().abs().max().item()
        new = slice(cl, cl + Q)
        dkv = torch.stack([_new_row_err(a, b, int4, new)
                           for a, b in zip(ck[:2], cp[:2])])     # [2, L]
        dsc = (torch.stack([_new_row_err(a, b, int4, new)
                            for a, b in zip(ck[2:], cp[2:])])
               if int4 else torch.zeros(2, L, device=dev))
        dkv0, dsc0 = dkv[:, 0].max().item(), dsc[:, 0].max().item()
        untouched = all(torch.equal(a[:, :, :cl], b[:, :, :cl])
                        and torch.equal(a[:, :, cl + Q:], b[:, :, cl + Q:])
                        for a, b in zip(ck, cp))
        exact = cl == 0
        atol0 = 0 if int4 else KV_LAYER0_ATOL
        if not (math.isfinite(rel) and rel1 <= DECODE_RTOL_1
                and rel <= DECODE_RTOL_36 and dkv0 <= atol0 and dsc0 == 0
                and untouched
                and (not exact or (err == 0 and dkv.max().item() == 0
                                   and dsc.max().item() == 0))):
            raise AssertionError(
                f"{name} B={B} Q={Q} cache_len={cl}: h rel err {rel1} at 1 "
                f"layer, {rel} at {L} (must be 0 here: {exact}); K/V row err "
                f"{dkv0} at layer 0, {dkv.max().item()} at any, scales "
                f"{dsc0} / {dsc.max().item()}; rest of the caches "
                f"untouched: {untouched}")
        ms = _time_ms(lambda: fn(packed, x, *ck, cl, n_head=H), 20)
        if (name, B, Q, cl) in (("w4", 10, 1, 1100), ("w4i4", 10, 1, 1100),
                                ("v5", 1, 1, 1100)):
            # the serving, the serving-i4 and the slice's step
            profiles[name] = _step_profile(
                lambda: fn(packed, x, *ck, cl, n_head=H), L,
                f"{name} steps, B = {B}, cache_len 1100")
        rows.setdefault(name, []).append({
            "B": B, "Q": Q, "cache_len": cl, "S": S, "max_abs_err": err,
            "rel_err": rel, "rel_err_1_layer": rel1,
            "kv_max_err_all_layers": dkv.max().item(),
            "scale_max_err_all_layers": dsc.max().item(),
            "attn_read": bool(cl),
            "attn_rel_err_max": attn[0], "attn_rel_err_mean": attn[1],
            "attn_elements_differing": attn[2],
            "attn_planted_faults": faults,
            "ms": ms, "plain_ms": pms, "library_ms": None,
            **_bound(*decode_work(name, L, d, H, B, Q, cl))})
        print(f"(b) {name} B={B} Q={Q} cache_len={cl} S={S}: h rel err "
              f"{rel1:.3g} (1 layer) / {rel:.3g} ({L} layers, max abs "
              f"{err:.3g}), new K/V rows max err layer 0 {dkv0} / all "
              f"layers {dkv.max().item()}"
              + (f", scales {dsc0} / {dsc.max().item():.3g}" if int4 else "")
              + (f", attention output max {attn[0]:.3g} / mean {attn[1]:.3g}"
                 f" ({attn[2]} elements differ)" if cl else "")
              + ("; planted faults (max / mean, each must fail): "
                 + ", ".join(f"{k} {e[0]:.3g} / {e[1]:.3g}"
                             for k, e in faults.items()) if faults else "")
              + f", kernel {ms:.3f} ms, plain {pms:.1f} ms, bound "
              f"{rows[name][-1]['bound_ms']:.4f} ms "
              f"({rows[name][-1]['bound_by']})")
        del cache, ck, cp
    return rows, profiles


# (kernel, cache type, B, cache_len) of the six steps added last: v1 and v2
# at the B = 1 of the slices that reach them, in every storage type they
# take; v3, v4, v6 at B = 2; v7 at B = 2 (slice-v7) and 8 (the largest B the
# reference routes to it: B·H = 128)
_CLS = (0, 1100, 2207)
VARIANT_CASES = (
    [("v2", kv, 1, cl) for kv in ("bfloat16", "float8_e4m3fn", "int8")
     for cl in _CLS]
    + [("v1", kv, 1, cl) for kv in ("bfloat16", "float8_e4m3fn")
       for cl in _CLS]
    + [(name, "int8", 2, cl) for name in ("v3", "v4", "v6") for cl in _CLS]
    + [("v7", "int8", B, cl) for B in (2, 8) for cl in _CLS])


def phase_variants(dev, cfg, packs, visible):
    """Phase b for v1, v2, v3, v4, v6 and v7 (bounds: see DECODE_RTOL_1)."""
    import torch
    from umgen_tpu_torch.ops import decode_kernel as dk
    L, d, H = cfg.n_oar_layer, cfg.n_embd, cfg.n_head
    S, Dh = 2208, d // H
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    tdt = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
           "int8": torch.int8}
    rows, profiles = {}, {}
    for name, kv, B, cl in VARIANT_CASES:
        dense = name in ("v1", "v2")
        fn = dk.fused_decode_step if name == "v1" else \
            getattr(dk, f"fused_decode_step_{name}")
        key_k = {"v1": "qoar", "v4": "v4"}.get(name, "v5")   # the kernel's
        key_p = "v4" if name == "v4" else "v5"               # the plain one's
        cache = _random_cache(g, dev, False, L, B, S, d, H)
        if dense and kv != "int8":      # the same values, off the grid's type
            cache = [(c.float() * 0.0625).to(tdt[kv]) for c in cache]
        x = torch.randn(B, 1, d, generator=g, device=dev).to(torch.bfloat16)
        ck = [t.clone() for t in cache]
        cp = cache
        c5 = ([t.clone() for t in cache] if name in ("v3", "v4", "v6")
              else None)                # for v5 on the same values

        def call(pk, c, xin=x, at=cl):
            if name in ("v3", "v4"):    # the reference's 5-D caches
                c = [t.view(t.shape[0], B, S, H, Dh) for t in c]
            return fn(pk, xin, *c, at, n_head=H)[0]

        def plain(pk, c, xin=x, at=cl, head_scale=name == "v7"):
            if dense:
                return dk.decode_step_dense_plain(pk, xin, c[0], c[1], at, H,
                                                  whole_s=name == "v1")
            return dk.decode_step_plain(
                pk, xin, c[0], c[1], at, H,
                prefer=dk.V2_BLOCKS if name in ("v3", "v4") else dk.V5_BLOCKS,
                head_scale=head_scale, rows_f32=name == "v6")

        def layer0(c):
            return [t[:1].clone() for t in c]

        def row_err(a, b):
            """[L]: the largest difference between the new rows of two
            caches, in grid steps (int8) or in value (bf16, fp8)."""
            return (a[:, :, cl].float() - b[:, :, cl].float()).abs().amax(
                dim=(1, 2))

        attn, faults = (0.0, 0.0), {}
        if cl and name in ("v1", "v2", "v7"):
            xs = (x.float() * 2.0 ** -6).to(torch.bfloat16)

            def readings(ref):
                dlt, r = (y - ref).abs(), ref.abs()
                return ((dlt.max() / r.max()).item(),
                        (dlt.mean() / r.mean()).item())

            def y_plain(c, at=cl, **kw):
                return plain(visible[key_p], c, xs, at, **kw).float() \
                    - xs.float()

            y = call(visible[key_k], layer0(ck), xs).float() - xs.float()
            attn = readings(y_plain(layer0(cp)))
            if cl == 1100:
                c0 = layer0(cp)
                faults["dropped_32_row_block"] = readings(y_plain(
                    [torch.cat([t[:, :, :512], t[:, :, 544:], t[:, :, :32]],
                               dim=2) for t in c0], cl - 32))
                if dense and kv == "bfloat16":
                    faults["bf16_cache_read_at_fp8_precision"] = readings(
                        y_plain([t.to(torch.float8_e4m3fn).to(t.dtype)
                                 for t in c0]))
                if name == "v7":
                    faults["scene_scale_for_head_scale"] = readings(
                        y_plain(c0, head_scale=False))
            # v1 and v2 keep every rounding point of the plain version on
            # its S-blocks: held as phase b's first half; the planted faults
            # are judged against the looser bound
            mean = ATTN_RTOL_MEAN_SBLOCKS if dense else ATTN_RTOL_MEAN
            passed = [k for k, e in faults.items() if attn_ok(e)]
            if not attn_ok(attn, mean) or passed:
                raise AssertionError(
                    f"{name} {kv} B={B} cache_len={cl}: attention output max "
                    f"err {attn[0]:.3g} of max |y| (bound {ATTN_RTOL_MAX:.3g})"
                    f", mean {attn[1]:.3g} of mean |y| (bound {mean:.3g}); "
                    f"planted faults that pass: {passed} of {faults}")

        h1 = call(_first_layer(packs[key_k]), layer0(ck))
        h1ref = plain(_first_layer(packs[key_p]), layer0(cp))
        h = call(packs[key_k], ck)
        t0 = time.perf_counter()
        href = plain(packs[key_p], cp)
        torch.cuda.synchronize()
        pms = 1e3 * (time.perf_counter() - t0)
        rel1 = ((h1.float() - h1ref.float()).abs().max()
                / h1ref.float().abs().max()).item()
        err = (h.float() - href.float()).abs().max().item()
        rel = err / href.float().abs().max().item()
        dkv = torch.stack([row_err(a, b) for a, b in zip(ck, cp)])   # [2, L]
        dkv0 = dkv[:, 0].max().item()
        untouched = all(
            torch.equal(a[:, :, :cl], b[:, :, :cl])
            and torch.equal(a[:, :, cl + 1:], b[:, :, cl + 1:])
            for a, b in ((a.view(torch.uint8), b.view(torch.uint8))
                         for a, b in zip(ck, cp)))
        exact = cl == 0
        ok = (math.isfinite(rel) and rel1 <= DECODE_RTOL_1
              and rel <= DECODE_RTOL_36 and untouched
              and dkv0 <= (0 if dense or name == "v6" else KV_LAYER0_ATOL)
              and (not exact or (err == 0 and dkv.max().item() == 0)))
        against_v5 = ""
        if c5 is not None:
            h5 = dk.fused_decode_step_v5(packs["v5"], x, *c5, cl, n_head=H)[0]
            d5 = max((a[:, :, cl].int() - b[:, :, cl].int()).abs().max().item()
                     for a, b in zip(ck, c5))
            same_h = torch.equal(h, h5)
            ok = ok and same_h and d5 <= (1 if name == "v6" else 0)
            against_v5 = (f", h equal to v5's: {same_h}, rows at most {d5} "
                          "steps from v5's")
        if not ok:
            raise AssertionError(
                f"{name} {kv} B={B} cache_len={cl}: h rel err {rel1} at 1 "
                f"layer, {rel} at {L} (must be 0 here: {exact}); new rows' "
                f"err {dkv0} at layer 0, {dkv.max().item()} at any; rest of "
                f"the caches untouched: {untouched}{against_v5}")
        ms = _time_ms(lambda: call(packs[key_k], ck), 20)
        if (name in ("v1", "v2") and kv == "bfloat16" and B == 1
                and cl == 1100):
            # the slice-bf16kv and the slice-v1 step
            profiles[name] = _step_profile(
                lambda: call(packs[key_k], ck), L,
                f"{name} steps, bf16 cache, B = 1, cache_len 1100")
        rows.setdefault(name, []).append({
            "kv": kv, "B": B, "Q": 1, "cache_len": cl, "max_abs_err": err,
            "rel_err": rel, "rel_err_1_layer": rel1,
            "kv_max_err_all_layers": dkv.max().item(),
            "attn_read": bool(cl) and name in ("v1", "v2", "v7"),
            "attn_rel_err_max": attn[0], "attn_rel_err_mean": attn[1],
            "attn_planted_faults": faults,
            "ms": ms, "plain_ms": pms, "library_ms": None,
            **_bound(*decode_work(name, L, d, H, B, 1, cl, kv))})
        print(f"(b) {name} {kv} B={B} cache_len={cl}: h rel err {rel1:.3g} "
              f"(1 layer) / {rel:.3g} ({L} layers, max abs {err:.3g}), new "
              f"rows max err layer 0 {dkv0:.3g} / all layers "
              f"{dkv.max().item():.3g}{against_v5}"
              + (f", attention output max {attn[0]:.3g} / mean {attn[1]:.3g}"
                 if cl and name in ("v1", "v2", "v7") else "")
              + ("; planted faults (max / mean, each must fail): "
                 + ", ".join(f"{k} {e[0]:.3g} / {e[1]:.3g}"
                             for k, e in faults.items()) if faults else "")
              + f", kernel {ms:.3f} ms, plain {pms:.1f} ms, bound "
              f"{rows[name][-1]['bound_ms']:.4f} ms "
              f"({rows[name][-1]['bound_by']})")
        del cache, ck, cp
    return rows, profiles


def _drive(model, params, cond, device, step, sampler, gen_kw=None):
    """The path the card-against-CPU phases drive, on either side, with
    `sampler` in every sampler slot: one frame step ("prefill", "chunked"
    or "recompute"; gen_kw {"forced": {mod: [B, len]}} teacher-forces those
    segments), or ("generate") `Generator.generate(cond, **gen_kw)`.
    Returns its tokens, ego logits and TAR priors on the CPU (a rollout's
    priors stacked frame by frame, its ego logits None)."""
    import numpy as np
    import torch
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.rollout import Rollout
    if step == "generate":
        gen = Generator(model, params, device=device)
        ro = gen.rollout
        ro._samplers = {m: sampler for m in ro._samplers}
        priors, finish = [], ro._finish_frame

        def kept(params, prior_seq, *a, **k):
            priors.append(prior_seq.cpu())
            return finish(params, prior_seq, *a, **k)

        ro._finish_frame = kept
        out = gen.generate(cond, **gen_kw)
        return {"tokens": torch.as_tensor(np.concatenate(
                    [out[m] for m in model.layout.mod_order], axis=-1)),
                "ego_logits": None, "prior_seq": torch.stack(priors)}
    ro = Rollout(model)
    ro._samplers = {m: sampler for m in ro._samplers}
    inputs = {m: torch.as_tensor(v, dtype=torch.long, device=device)
              for m, v in cond.items()}
    g = torch.Generator(device)
    kw = {"forced_tokens": {m: torch.as_tensor(v, dtype=torch.long,
                                               device=device)
                            for m, v in gen_kw["forced"].items()}} \
        if gen_kw else {}
    if step == "recompute":
        out = ro.frame_step(params, inputs, g, **kw)
    else:
        fn = ro.frame_step_chunked if step == "chunked" else \
            ro.frame_step_prefill
        out = fn(params, inputs, g, **kw)[0]
    return {k: getattr(out, k).cpu()
            for k in ("tokens", "ego_logits", "prior_seq")}


def _cpu_replay(job_path):
    """Entry of the child process of `_CardVsCpu`: replay the card's
    decisions through the plain versions on the CPU and save what it saw
    beside the job.  Two intra-op threads: the children and the parent,
    which goes on driving the card, share the host's cores."""
    import torch
    from umgen_tpu_torch.models.umgen import UMGen
    torch.set_num_threads(2)
    job = torch.load(job_path, weights_only=False)
    replay = iter(job["tokens"])
    seen = []

    def sampler(gen, logits):
        seen.append(logits.clone())
        return next(replay)

    t0 = time.perf_counter()
    out = _drive(UMGen(job["cfg"]), job["params"], job["cond"], "cpu",
                 job["step"], sampler, job["gen_kw"])
    torch.save(dict(out, logits=seen, seconds=time.perf_counter() - t0),
               job_path + ".out")


class _CardVsCpu:
    """One card-against-CPU check.  Creating it runs the path (`_drive`)
    on `dev` and starts a child process that runs it on the CPU (the plain
    versions) from the same weights, replaying the card's sampler
    decisions, so that both decode one token stream; the card goes on with
    the next phases meanwhile.  `finish()` waits for the child and
    compares: the tokens must be equal, and the ego logits, TAR priors and
    every decision's logits must agree within the bounds."""

    def __init__(self, dev, cfg, params, step, B, T, tag, rtol_priors,
                 rtol_logits, work_dir, cond=None, gen_kw=None, must=None):
        import multiprocessing

        import torch
        from umgen_tpu_torch.data.synthetic import make_token_batch
        from umgen_tpu_torch.models.sampling import greedy_sample
        from umgen_tpu_torch.models.umgen import UMGen
        self.cfg, self.B, self.tag, self.dev = cfg, B, tag, dev
        self.step = step
        self.rtol_priors, self.rtol_logits = rtol_priors, rtol_logits
        model = UMGen(cfg)

        def to_cpu(t):
            return ({k: to_cpu(v) for k, v in t.items()}
                    if isinstance(t, dict) else t.cpu())

        if cond is None:
            cond = make_token_batch(model.layout, T=T, B=B, seed=0,
                                    config=cfg)
        self.logits, tokens = [], []

        def sampler(gen, logits):
            tok = greedy_sample(gen, logits)
            self.logits.append(logits.cpu())
            tokens.append(tok.cpu())
            return tok

        t0 = time.perf_counter()
        _reset_launches()
        self.run = _drive(model, params, cond, dev, step, sampler, gen_kw)
        self.device_s = time.perf_counter() - t0
        # `must`: the decode kernels the card's run has to launch, and no
        # other (flash always)
        self.launches = None if must is None else _launches(must)
        self.job = os.path.join(work_dir, f"replay_{tag}.pt")
        torch.save({"cfg": cfg, "params": to_cpu(params), "cond": cond,
                    "tokens": tokens, "step": step, "gen_kw": gen_kw},
                   self.job)
        self.child = multiprocessing.get_context("spawn").Process(
            target=_cpu_replay, args=(self.job,))
        self.child.start()

    def stop(self):
        if self.child.is_alive():
            self.child.terminate()
        self.child.join()

    def finish(self):
        import torch
        self.child.join()
        if self.child.exitcode != 0:
            raise AssertionError(f"phase {self.tag}: the CPU replay exited "
                                 f"with code {self.child.exitcode}")
        cpu = torch.load(self.job + ".out", weights_only=False)

        def rel(a, b):
            # over the finite entries (the control override masks <pad>
            # with -inf); the -inf entries must coincide
            if a is None and b is None:      # a rollout's ego logits
                return 0.0
            a, b = a.float(), b.float()
            fin = torch.isfinite(b)
            if not torch.equal(fin, torch.isfinite(a)):
                return math.inf
            return ((a - b)[fin].abs().max() / b[fin].abs().max()).item()

        err_ego = rel(cpu["ego_logits"], self.run["ego_logits"])
        err_pri = rel(cpu["prior_seq"], self.run["prior_seq"])
        n = len(self.logits)
        if len(cpu["logits"]) != n:
            raise AssertionError(f"{n} decisions on the device, "
                                 f"{len(cpu['logits'])} on the CPU")
        errs = [rel(c, d) for c, d in zip(cpu["logits"], self.logits)]
        worst = max(range(n), key=errs.__getitem__)
        same = torch.equal(cpu["tokens"], self.run["tokens"])
        res = {"decisions": n, "ego_logits_rel_err": err_ego,
               "priors_rel_err": err_pri, "logits_rel_err_max": errs[worst],
               "logits_rel_err_mean": sum(errs) / n, "tokens_equal": same,
               "device_s": self.device_s, "cpu_s": cpu["seconds"],
               "launches": self.launches}
        print(f"({self.tag}) {self.cfg.n_tar_layer}-layer stacks, "
              f"{self.step}, "
              f"B={self.B}, on {self.dev} vs the CPU: ego logits rel err "
              f"{err_ego:.3g}, priors {err_pri:.3g}, logits of {n} decisions "
              f"max {errs[worst]:.3g} (decision {worst}) mean "
              f"{res['logits_rel_err_mean']:.3g}; tokens equal: {same}; "
              f"{res['device_s']:.1f} s on the card, {res['cpu_s']:.1f} s in "
              "the CPU's child process")
        if not (same and err_ego <= self.rtol_priors
                and err_pri <= self.rtol_priors
                and errs[worst] <= self.rtol_logits):
            raise AssertionError(f"the model on {self.dev} disagrees with "
                                 f"the plain versions on the CPU: {res}")
        return res


def _reference_params(dev, cfg, seed):
    """Seeded debug-scale weights for a card-against-CPU phase: int8 decode
    weights, packed for the decode kernels under `fused_oar_kernel`."""
    import torch
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import (pack_fused,
                                                  quantize_params_int8)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = quantize_params_int8(init_params(cfg, g, dev))
    if cfg.fused_oar_kernel:
        params = pack_fused(params, kv_dtype=cfg.oar_cache_dtype)
    return params


def _slice_cfg(**changes):
    """The bf16-ring slice at debug scale (one layer a stack, full width),
    greedy, with the config `changes`."""
    from umgen_tpu_torch.config import ModelConfig
    return ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                       tar_cache_dtype="bfloat16", oar_cache_dtype="int8",
                       fused_oar_kernel=True, tar_cache_window=20
                       ).replace(**changes).scaled("debug")


def phase_reference(dev, work_dir, tag="d", step="prefill", **changes):
    """One frame of the bf16-ring slice, B = 1, a 2-frame window, greedy,
    every stack one layer deep at full width, card against CPU, with the
    config `changes`: the OAR cache int8 (phase d: v5, v5mq) or bfloat16
    (phase n: v2 and the eager pushes); recompute (phase r, `step`
    "recompute"), or the reference CLI's default run (phase r: fp8 rings,
    the unfused decode on an fp8 OAR cache, unpacked int8 weights).
    Returns the started _CardVsCpu."""
    cfg = _slice_cfg(**changes)
    return _CardVsCpu(dev, cfg, _reference_params(dev, cfg, 3), step, B=1,
                      T=2, tag=tag, rtol_priors=REF_RTOL_PRIORS,
                      rtol_logits=REF_RTOL_LOGITS, work_dir=work_dir)


# phase t's rollouts: a 2-frame window, 2 generated frames, map and image
# forced to a seeded continuation (the decode is the frames' 660 box
# positions, which keeps the CPU sides short)
CONTROL_CASES = {
    "t-control-cached": dict(tar_cache_window=2),
    "t-control-recompute": dict(tar_mode="recompute"),
    "t-init-token-mod": dict(tar_cache_window=2),
}


def phase_control_reference(dev, work_dir, tag):
    """(t) `Generator.generate` at debug scale, B = 1, card against CPU:
    agent control (the pkl's ego trajectory and two agents' boxes under
    `control_test`) in cached and in recompute mode, and the video task's
    `--init_token_mod map,image` replay.  Returns the started
    _CardVsCpu."""
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.models.umgen import UMGen
    cfg = _slice_cfg(**CONTROL_CASES[tag])
    layout = UMGen(cfg).layout
    cond = make_token_batch(layout, T=2, B=1, seed=0, config=cfg)
    nxt = make_token_batch(layout, T=2, B=1, seed=1, config=cfg)
    kw = dict(new_frames=2, cond_frames=2, input_cond_frames=2,
              forced_streams={m: nxt[m] for m in ("map", "image")})
    if tag != "t-init-token-mod":
        ctrl = nxt["bbox3d"].copy()
        ctrl[:, :, 33:] = -1                        # agents 0-2 controlled
        kw.update(init_tokens={"pose": nxt["pose"], "bbox3d": ctrl},
                  control_test=True)
    return _CardVsCpu(dev, cfg, _reference_params(dev, cfg, 5), "generate",
                      B=1, T=2, tag=tag, rtol_priors=REF_RTOL_PRIORS,
                      rtol_logits=REF_RTOL_LOGITS, work_dir=work_dir,
                      cond=cond, gen_kw=kw)


# phase w: the options of this slice at debug scale, card against CPU.  Map
# and image are teacher-forced (the decode is the 660 box positions, which
# keeps the CPU sides short); speculation runs on the serving configuration
# (W4A8 OAR weights, int4 rings: phase f's bounds, the ring type sets them)
# with the int8 OAR cache (w4mq verify chunks, B = 2) and the int4 one
# (w4mqi4, B = 1); W4 TAR weights on int2 rings roll two frames after a
# 2-frame window (the full-window prefill freezes the equalizers, the
# second frame reads the rings); the relative PE (a seeded nonzero tpe_rel)
# decodes one frame read from 2-frame rings after a chunked 3-frame window,
# and one recompute frame over a 3-frame window.  The
# int2 rings keep phase f's bounds too: a K/V value a bf16 ulp apart
# between the devices lands one level apart in ~0.1% of a ring (CPU against
# JAX: tests/test_torch_tar_options.py).
OPTION_CASES = {
    "w-spec-serving": dict(kernels=("w4mq",), B=2),
    "w-spec-i4": dict(kernels=("w4mqi4",), B=1, oar_cache_dtype="int4"),
    "w-w4-int2": dict(kernels=("v5", "v5mq"),
                      cfg=dict(tar_cache_dtype="int2", tar_cache_window=2)),
    "w-relative-cached": dict(kernels=("v5", "v5mq"), step="chunked",
                              cfg=dict(temporal_pe_mode="relative",
                                       tar_cache_window=2)),
    "w-relative-recompute": dict(kernels=("v5", "v5mq"), step="recompute",
                                 cfg=dict(temporal_pe_mode="relative",
                                          tar_mode="recompute")),
}


def phase_options_reference(dev, work_dir, tag):
    """(w) one case of OPTION_CASES on the card and on the CPU, as (d); the
    card's run must launch the case's decode kernels and no other.
    Returns the started _CardVsCpu."""
    import torch
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.runtime.quantize import quantize_params_w4
    from umgen_tpu_torch.tools.evaluate import serving_params
    case = OPTION_CASES[tag]
    if tag.startswith("w-spec"):
        cfg = ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                          tar_cache_dtype="int4",
                          oar_cache_dtype=case.get("oar_cache_dtype",
                                                   "int8"),
                          fused_oar_kernel=True, chunked_prefill=True,
                          tar_cache_window=2, speculative_k=8
                          ).scaled("debug")
        g = torch.Generator(device=dev)
        g.manual_seed(6)
        params = serving_params(cfg, g, dev)
        layout = UMGen(cfg).layout
        nxt = make_token_batch(layout, T=1, B=case["B"], seed=1, config=cfg)
        return _CardVsCpu(
            dev, cfg, params, "chunked", B=case["B"], T=3, tag=tag,
            rtol_priors=SERVE_RTOL_PRIORS, rtol_logits=SERVE_RTOL_LOGITS,
            work_dir=work_dir, must=case["kernels"],
            gen_kw={"forced": {m: nxt[m][:, 0] for m in ("map", "image")}})
    cfg = _slice_cfg(**case["cfg"])
    params = _reference_params(dev, cfg, 7)
    if cfg.tar_cache_dtype == "int2":
        params = quantize_params_w4(params)
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    params["tpe_rel"] = 0.5 * torch.randn(params["tpe_rel"].shape,
                                          generator=g, device=dev)
    layout = UMGen(cfg).layout
    step = case.get("step", "generate")
    T = 2 if step == "generate" else 3
    cond = make_token_batch(layout, T=T, B=1, seed=0, config=cfg)
    nxt = make_token_batch(layout, T=2, B=1, seed=1, config=cfg)
    forced = ("map", "image")
    kw = dict(new_frames=2, cond_frames=2, input_cond_frames=2,
              forced_streams={m: nxt[m] for m in forced}) \
        if step == "generate" else {"forced": {m: nxt[m][:, 0]
                                               for m in forced}}
    rtol = (SERVE_RTOL_PRIORS, SERVE_RTOL_LOGITS) \
        if cfg.tar_cache_dtype == "int2" else (REF_RTOL_PRIORS,
                                               REF_RTOL_LOGITS)
    return _CardVsCpu(dev, cfg, params, step, B=1, T=T, tag=tag,
                      rtol_priors=rtol[0], rtol_logits=rtol[1],
                      work_dir=work_dir, cond=cond, gen_kw=kw,
                      must=case["kernels"])


def phase_serving_reference(dev, work_dir, tag="f", oar_cache_dtype="int8",
                            B=2):
    """The serving configuration at debug scale, B scenes, a 3-frame window
    into 2-frame int4 rings by chunked prefill (frames 0-1 ingested, frame
    2 through a cached step, as Generator does), card against CPU; the OAR
    cache int8 (phase f, two scenes) or int4 (phase i, one).  Returns the
    started _CardVsCpu."""
    import torch
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.tools.evaluate import serving_params
    cfg = ModelConfig(sample_method="greedy", tar_mode="temporal_cache",
                      tar_cache_dtype="int4",
                      oar_cache_dtype=oar_cache_dtype,
                      fused_oar_kernel=True, chunked_prefill=True,
                      tar_cache_window=2).scaled("debug")
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    params = serving_params(cfg, g, dev)
    if "wqp4" not in params["oar_packed"]:
        raise AssertionError(f"phase {tag} needs W4A8 OAR weights")

    return _CardVsCpu(dev, cfg, params, "chunked", B=B, T=3, tag=tag,
                      rtol_priors=SERVE_RTOL_PRIORS,
                      rtol_logits=SERVE_RTOL_LOGITS, work_dir=work_dir)


def vq_decode_flops(cfg, grid) -> int:
    """FLOPs (2 a multiply-add) of one frame's VQ decode at the token grid
    `grid`: every convolution and the attention's products; the group
    norms, swish and the nearest upsampling's copies not counted."""
    H, W = grid

    def conv(cin, cout, k):
        return 2 * k * k * cin * cout * H * W

    def res(cin, cout):
        return conv(cin, cout, 3) + conv(cout, cout, 3) + \
            (conv(cin, cout, 1) if cin != cout else 0)

    def attn(c):
        return 4 * conv(c, c, 1) + 4 * (H * W) ** 2 * c

    c = cfg.ch * cfg.ch_mult[-1]
    flops = conv(cfg.embed_dim, cfg.z_channels, cfg.post_quant_kernel) + \
        conv(cfg.z_channels, c, 3) + 2 * res(c, c) + attn(c)
    res_at = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
    for i_level in reversed(range(cfg.num_resolutions)):
        out = cfg.ch * cfg.ch_mult[i_level]
        for _ in range(cfg.num_res_blocks + 1):
            flops += res(c, out)
            c = out
            if res_at in cfg.attn_resolutions:
                flops += attn(c)
        if i_level:
            H, W, res_at = 2 * H, 2 * W, 2 * res_at
            flops += conv(c, c, 3)
    return flops + conv(c, cfg.out_ch, 3)


def _vq_cpu_decode(job_path):
    """Entry of phase x's child process: the same decoders on the CPU, the
    same frames in one chunk.  Two intra-op threads, as `_cpu_replay`."""
    import torch
    from umgen_tpu_torch.models import vq
    torch.set_num_threads(2)
    job = torch.load(job_path, map_location="cpu", weights_only=False)
    t0 = time.perf_counter()
    out = {"maps": vq.MapDecoder(job["map"], device="cpu").decode(
               job["map_tokens"]),
           "images": vq.ImageDecoder(job["image"], device="cpu").decode(
               job["image_tokens"])}
    torch.save(dict(out, seconds=time.perf_counter() - t0),
               job_path + ".out")


class _VqCardVsCpu:
    """Phase x's card-against-CPU check: the card's pictures of the first
    frames are taken before; a child process decodes the same frames with
    the same weights on the CPU while the card goes on.  `finish()`
    compares them within VQ_ATOL."""

    def __init__(self, job, card, work_dir):
        import multiprocessing

        import torch
        self.card = card
        self.job = os.path.join(work_dir, "replay_x.pt")
        torch.save(job, self.job)
        self.child = multiprocessing.get_context("spawn").Process(
            target=_vq_cpu_decode, args=(self.job,))
        self.child.start()

    def stop(self):
        if self.child.is_alive():
            self.child.terminate()
        self.child.join()

    def finish(self):
        import numpy as np
        import torch
        self.child.join()
        if self.child.exitcode != 0:
            raise AssertionError("phase x: the CPU decode exited with code "
                                 f"{self.child.exitcode}")
        cpu = torch.load(self.job + ".out", weights_only=False)
        res = {"frames": len(self.card["maps"]), "cpu_s": cpu["seconds"],
               "atol": VQ_ATOL}
        for k in ("maps", "images"):
            res[f"{k}_max_abs_err"] = float(np.abs(
                cpu[k] - self.card[k]).max())
            res[f"{k}_max_abs"] = float(np.abs(cpu[k]).max())
        print(f"(x) VQ decoders on the card vs the CPU, {res['frames']} "
              f"frames in one chunk: maps max abs err "
              f"{res['maps_max_abs_err']:.3g} (of |x| <= "
              f"{res['maps_max_abs']:.3g}), images "
              f"{res['images_max_abs_err']:.3g} (of "
              f"{res['images_max_abs']:.3g}); bound {VQ_ATOL:g}; "
              f"{res['cpu_s']:.1f} s in the CPU's child process")
        if max(res["maps_max_abs_err"], res["images_max_abs_err"]) > VQ_ATOL:
            raise AssertionError(f"the VQ decoders on the card disagree with "
                                 f"the CPU: {res}")
        return res


def phase_vq(dev, work_dir):
    """(x) The map and image VQ detokenizers at full width (MAP_VQ,
    IMAGE_VQ; seeded weights) on the card, on a synthetic scene's 21
    frames of phase c's layout: SceneRunner._postprocess with the scene as
    its own GT (token pickle, decode, metrics and, where cv2 imports, the
    pred | GT mp4, whose GT maps are decoded too), then decode_tokens
    alone; the pictures' shapes, finiteness and range, no decode journal,
    none of the fifteen kernels launched.  Times each decoder in ms a frame
    at its chunk of 20 (CUDA events) beside its bound (FLOPs over the
    float32 peak), and starts the card-against-CPU check of the first two
    frames (`_VqCardVsCpu`).  Returns (report, check)."""
    import numpy as np
    import torch
    from umgen_tpu_torch.config import InferConfig, ModelConfig
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.layout import SequenceLayout
    from umgen_tpu_torch.models import vq
    from umgen_tpu_torch.tools import visualize
    from umgen_tpu_torch.tools.harness import SceneRunner

    cfg = ModelConfig().scaled("larger")
    scene = make_token_batch(SequenceLayout(cfg.task), T=VQ_FRAMES, B=1,
                             seed=0, config=cfg)
    t0 = time.perf_counter()
    params = {"map": vq.init_normvq(torch.Generator(dev).manual_seed(0),
                                    vq.MAP_VQ, dev),
              "image": vq.init_normvq(torch.Generator(dev).manual_seed(1),
                                      vq.IMAGE_VQ, dev)}
    decoders = {"map": vq.MapDecoder(params["map"], device=dev),
                "image": vq.ImageDecoder(params["image"], device=dev)}
    torch.cuda.synchronize()
    res = {"build_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        runner = SceneRunner(None, InferConfig(), output_path=out_dir,
                             pipeline=ScenePipeline(),
                             map_decoder=decoders["map"],
                             image_decoder=decoders["image"],
                             save_video=visualize.HAS_CV2)
        _reset_launches()
        t0 = time.perf_counter()
        runner._postprocess(scene, scene, "vq_scene", input_cond=20)
        res["postprocess_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = runner.decode_tokens(scene)
        res["decode_tokens_s"] = time.perf_counter() - t0
        _launches((), flash=False)
        if os.path.exists(os.path.join(runner.token_save_path,
                                       "undecoded_token.txt")):
            raise AssertionError("(x) a decode failed: undecoded_token.txt "
                                 "was written")
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        if visualize.HAS_CV2:
            import cv2
            cap = cv2.VideoCapture(os.path.join(runner.video_save_path,
                                                "vq_scene.mp4"))
            res["mp4"] = {"frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                          "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                          "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))}
            cap.release()
            if res["mp4"]["frames"] != VQ_FRAMES:
                raise AssertionError(f"(x) the mp4 has {res['mp4']} frames, "
                                     f"not {VQ_FRAMES}")
        else:
            print("(x) cv2 does not import here: no mp4 written (the CPU "
                  "tests hold the mp4 path)")
            res["mp4"] = "not written: no cv2"
    frame = VQ_PICTURES
    want = {"maps_rgb": (VQ_FRAMES,) + frame["map"],
            "images": (VQ_FRAMES,) + frame["image"]}
    for k, shape in want.items():
        x = decoded[k]
        if x.shape != shape or x.dtype != np.float32 or \
                not np.isfinite(x).all():
            raise AssertionError(f"(x) {k}: {x.shape} {x.dtype}, finite "
                                 f"{np.isfinite(x).all()}; want {shape}")
    if decoded["maps_rgb"].min() < -1 or decoded["maps_rgb"].max() > 1:
        raise AssertionError("(x) maps_rgb outside [-1, 1]")

    # ms a frame at the chunk of 20, on the card's own tensors
    for name, grid in (("map", (32, 32)), ("image", (16, 32))):
        dec = decoders[name]
        idx = torch.as_tensor(scene[name][0, :20].reshape(20, *grid),
                              dtype=torch.long, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad(), vq.float32_products():
            ms = _time_ms(lambda: dec._pictures(idx), reps=3, warmup=1) / 20
        peak = torch.cuda.max_memory_allocated()
        flops = vq_decode_flops(dec.cfg, grid)
        weights = sum(t.numel() * t.element_size() for k, v in
                      dec.params.items() if k not in ("encoder", "quant_conv")
                      for t in _tensors(v))
        # a frame's bytes: its tokens in, its picture out, a twentieth of
        # the weights (read once a chunk)
        nbytes = 8 * math.prod(grid) + 4 * math.prod(frame[name]) \
            + weights / 20
        res[name] = {"ms_per_frame": ms, "gflop_per_frame": flops / 1e9,
                     "tflop_s": flops / (ms * 1e9),
                     "max_memory_allocated": peak,
                     **_bound(nbytes, flops / H100_FP32_FLOPS)}
        print(f"(x) {name} decoder: {ms:.2f} ms a frame at chunk 20 "
              f"({flops / 1e9:.1f} GFLOP a frame, {flops / (ms * 1e9):.1f} "
              f"TFLOP/s); bound {res[name]['bound_ms']:.2f} ms "
              f"({res[name]['bound_by']}, the float32 peak 67 TFLOP/s); "
              f"peak device memory {peak / 2**30:.2f} GiB")
    print(f"(x) built in {res['build_s']:.1f} s; _postprocess (decode, "
          f"pred | GT video: mp4 {res['mp4']}) {res['postprocess_s']:.1f} s, "
          f"decode_tokens {res['decode_tokens_s']:.1f} s; peak device "
          f"memory over both {res['max_memory_allocated'] / 2**30:.2f} GiB")

    first = {"map": scene["map"][0, :2], "image": scene["image"][0, :2]}
    card = {"maps": decoders["map"].decode(first["map"]),
            "images": decoders["image"].decode(first["image"])}
    job = {name: {k: v for k, v in p.items()
                  if k not in ("encoder", "quant_conv")}
           for name, p in params.items()}
    job.update(map_tokens=first["map"], image_tokens=first["image"])
    return res, _VqCardVsCpu(job, card, work_dir)


# ---------------------------------------------------------------------------
# (y) training
# ---------------------------------------------------------------------------
def train_step_flops(cfg, B, T):
    """(bf16 FLOPs, float32 FLOPs) of one forward pass of the trainer's
    loss at 2 FLOPs a multiply-add: the products of every linear layer in
    the activation dtype (bf16), the attention's QKᵀ and PV in float32 (the
    plain `sdpa` contracts float32 copies), over the W = T - 1 window slots
    of the ego net and the TAR cascade and the final frame's OAR pass, the
    heads and the token embeddings' MLPs.  A step's backward pass costs
    twice the forward, and remat recomputes the stacks' forward once more
    (`train_step_work`)."""
    from umgen_tpu_torch.layout import SequenceLayout
    lo = SequenceLayout(cfg.task)
    D, W, S = cfg.n_embd, T - 1, lo.seq_len
    seg = {s.mod: s.content_len for s in lo.segments}
    lin = {"stacks": 0, "other": 0}
    att = {"stacks": 0, "other": 0}

    def tar(L, S_):                        # L factorized blocks over W frames
        lin["stacks"] += L * 2 * 36 * D * D * B * W * S_
        att["stacks"] += L * (2 * 4 * B * W * S_ * S_ * D
                              + 4 * B * S_ * W * W * D)

    tar(cfg.n_tar_layer, S)
    tar(cfg.n_ego_tar_layer, S)
    tar(cfg.n_map_tar_layer, 5 + 1026)
    tar(cfg.n_box_tar_layer, 5 + 1026 + 662)
    # ego queries: 3 a frame, self + cross attention over the frame's S
    q = B * W * 3
    lin["stacks"] += cfg.n_ego_ca_layer * 2 * (14 * D * D * q
                                               + 2 * D * D * B * W * S)
    att["stacks"] += cfg.n_ego_ca_layer * B * W * (4 * 9 * D + 4 * 3 * S * D)
    # the OAR pass over the final frame (causal, computed in full)
    lin["stacks"] += cfg.n_oar_layer * 2 * 12 * D * D * B * S
    att["stacks"] += cfg.n_oar_layer * 4 * B * S * S * D
    # heads: ego, TAR (content + separators, every slot), OAR (final frame)
    vocab = {"pose": cfg.pose_vocab_size, "map": cfg.map_vocab_size,
             "bbox3d": cfg.bbox3d_vocab_size, "image": cfg.img_vocab_size}
    heads = q * cfg.pose_vocab_size
    for mod, n in seg.items():
        if mod != "pose":
            heads += B * W * (n * vocab[mod] + 2 * cfg.aux_vocab_size)
        heads += B * n * vocab[mod]
    # map / image token embeddings (16 → 4D → D): the trunk's, the ego
    # net's, the map and box stacks' inputs over W frames, the OAR's one
    emb_tokens = (4 * W + 1) * B * seg["map"] + (2 * W + 1) * B * seg["image"]
    lin["other"] += 2 * D * heads + 2 * emb_tokens * (16 * 4 * D + 4 * D * D)
    return lin, att


def train_step_work(cfg, B, T, remat=True):
    """(executed bf16 FLOPs, executed float32 FLOPs, the model's FLOPs
    3 × forward) of one train step."""
    lin, att = train_step_flops(cfg, B, T)
    fwd16, fwd32 = sum(lin.values()), sum(att.values())
    redo16 = lin["stacks"] if remat else 0
    redo32 = att["stacks"] if remat else 0
    return 3 * fwd16 + redo16, 3 * fwd32 + redo32, 3 * (fwd16 + fwd32)


def _kernel_kind(name):
    """A kernel's kind, from its name, for phase y's profile."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low or "xmma" in low:
        return "float32 GEMM" if "f32f32" in low else "bf16 GEMM"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low or "copy" in low:
        return "elementwise"
    return "other"


def _device_table(fn):
    """fn once under torch.profiler (CUDA activity only; a full-width
    train step launches ~170k kernels, so the raw kineto events are summed
    here, which takes seconds where `key_averages` took minutes): the
    device seconds and launches by kernel name (the TRAIN_PROFILE_TOP
    largest) and by kind, the busy share over the host clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e9
    kinds = {}
    for name, (n, sec) in by_name.items():
        row = kinds.setdefault(_kernel_kind(name), [0, 0.0])
        row[0] += n
        row[1] += sec
    device = sum(sec for _, sec in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"wall_s": wall, "device_s": device, "busy": device / wall,
            "launches": sum(n for n, _ in by_name.values()),
            "kinds": dict(sorted(kinds.items(), key=lambda kv: -kv[1][1])),
            "kernels": dict(top[:TRAIN_PROFILE_TOP])}


def _train_cpu_step(job_path):
    """Entry of phase y's child process: the same AdamW step on the CPU,
    from the same weights and batch.  Two intra-op threads, as
    `_cpu_replay`."""
    import torch
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.parallel import optim
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    torch.set_num_threads(2)
    job = torch.load(job_path, weights_only=False)
    trainer = UMGenTrainer(UMGen(job["cfg"]), **job["trainer"])
    state = trainer.init_state(job["params"])
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(state, job["batch"])
    torch.save({"metrics": metrics,
                "params": optim.tree_map(lambda t: t.detach(), state.params),
                "opt_state": state.opt_state,
                "seconds": time.perf_counter() - t0}, job_path + ".out")


def _grad_errors(ref_opt, opt):
    """Each gradient leaf, read from the first Adam moment mu = 0.1·g, of
    `opt` against `ref_opt`: the largest relative L2 error; a leaf zero in
    the reference must be zero, a roundoff leaf (below 1e-7 of the global
    norm) must stay below that.  Returns (worst, zeros, roundoff)."""
    from umgen_tpu_torch.parallel import optim
    mu_ref = list(optim.tree_leaves(ref_opt[1][0]["mu"]))
    mu = list(optim.tree_leaves(opt[1][0]["mu"]))
    gnorm = float(optim.global_norm(mu_ref))
    worst, zeros, roundoff = 0.0, 0, 0
    for a, b in zip(mu_ref, mu):
        b = b.float()
        na = float(a.norm())
        if na == 0:
            zeros += 1
            if b.any():
                worst = math.inf
        elif na <= 1e-7 * gnorm:
            roundoff += 1
            if float(b.norm()) > 1e-7 * gnorm:
                worst = math.inf
        else:
            worst = max(worst, float((b - a).norm()) / na)
    return worst, zeros, roundoff


class _TrainCardVsCpu:
    """Phase y's card-against-CPU check: the card's step is taken before;
    a child process takes the same step on the CPU while the card goes on.
    `finish()` holds the loss terms and grad_norm (TRAIN_LOSS_RTOL), each
    gradient leaf read from the first moment mu = 0.1·g (TRAIN_GRAD_RTOL
    relative L2; a leaf zero on the CPU zero on the card, a roundoff leaf
    below 1e-7 of the global norm on both) and the params after the step
    (TRAIN_PARAM_ATOL)."""

    def __init__(self, job, card, work_dir):
        import multiprocessing

        import torch
        self.card = card
        self.job = os.path.join(work_dir, "replay_y.pt")
        torch.save(job, self.job)
        self.child = multiprocessing.get_context("spawn").Process(
            target=_train_cpu_step, args=(self.job,))
        self.child.start()

    def stop(self):
        if self.child.is_alive():
            self.child.terminate()
        self.child.join()

    def finish(self):
        import torch
        from umgen_tpu_torch.parallel import optim
        self.child.join()
        if self.child.exitcode != 0:
            raise AssertionError("phase y: the CPU step exited with code "
                                 f"{self.child.exitcode}")
        cpu = torch.load(self.job + ".out", weights_only=False)
        card = self.card
        res = {"cpu_s": cpu["seconds"], "card_s": card["seconds"]}
        res["metrics_rel_err"] = {
            k: abs(float(card["metrics"][k]) - float(v)) / abs(float(v))
            for k, v in cpu["metrics"].items()}
        worst, zeros, roundoff = _grad_errors(cpu["opt_state"],
                                              card["opt_state"])
        res.update(grad_rel_l2_max=worst, zero_leaves=zeros,
                   roundoff_leaves=roundoff)
        res["params_max_abs_err"] = max(
            float((b.float() - a).abs().max()) for a, b in zip(
                optim.tree_leaves(cpu["params"]),
                optim.tree_leaves(card["params"])))
        print(f"(y) tiny float32 AdamW step on the card vs the CPU: loss "
              f"terms rel err max {max(res['metrics_rel_err'].values()):.3g} "
              f"(bound {TRAIN_LOSS_RTOL:g}), gradients (mu / 0.1) rel L2 "
              f"max {worst:.3g} (bound {TRAIN_GRAD_RTOL:g}; {zeros} zero and "
              f"{roundoff} roundoff leaves), params after the step max abs "
              f"err {res['params_max_abs_err']:.3g} (bound "
              f"{TRAIN_PARAM_ATOL:g}); {res['cpu_s']:.1f} s in the CPU's "
              "child process")
        if (max(res["metrics_rel_err"].values()) > TRAIN_LOSS_RTOL
                or worst > TRAIN_GRAD_RTOL
                or res["params_max_abs_err"] > TRAIN_PARAM_ATOL):
            raise AssertionError(f"the trainer on the card disagrees with "
                                 f"the CPU: {res}")
        return res


def _train_batch(layout, cfg, T, dev, seed=0):
    import torch
    from umgen_tpu_torch.data.synthetic import make_token_batch
    raw = make_token_batch(layout, T=T, B=1, seed=seed, config=cfg)
    return {k: torch.as_tensor(v, dtype=torch.long, device=dev)
            for k, v in raw.items()}


def phase_train(dev, work_dir):
    """(y) Training on the card.  (1) UMGen_Large (`--model_scale larger`),
    seeded bf16 weights, use_pallas_attention=False, remat, AdamW at lr
    3e-4 warming up over 1 of 10 steps, B = 1, a 4-frame window of one
    synthetic scene, three steps on that batch: the loss and the grad norm
    finite at each, the third step's loss below the first's (the first
    update is the warmup no-op), none of the fifteen kernels launched;
    each step's seconds (CUDA events and the host clock), the peak device
    memory, the FLOPs of a step and the rate.  (2) One AdamW step at the
    tiny scale in float32 on the card, and in a child process on the CPU
    from the same weights and batch (`_TrainCardVsCpu`).  (3) At debug
    scale (full width, one layer a stack): a step, the train state saved
    and loaded, one more step from each: params and optimizer state equal
    bit for bit.  (4) The map VQ codec at MAP_VQ's published size, B = 2,
    three Adam steps (tools.train_vq.VQTrainer): finite losses,
    perplexity >= 1; saved in the inference layout, and two frames of
    tokens decoded by MapDecoder from that save.  Returns (report,
    check)."""
    import numpy as np
    import torch
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.layout import SequenceLayout
    from umgen_tpu_torch.models import vq
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.parallel import optim
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime import checkpoint as ckpt
    from umgen_tpu_torch.tools.train_vq import VQTrainer, synthetic_rasters

    kw = dict(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    res = {}
    # (1) full width and depth
    cfg = ModelConfig(use_pallas_attention=False, remat=True).scaled(
        "larger")
    model = UMGen(cfg)
    trainer = UMGenTrainer(model, **kw)
    t0 = time.perf_counter()
    state = trainer.init_state(init_params(
        cfg, torch.Generator(dev).manual_seed(0), dev))
    batch = _train_batch(model.layout, cfg, TRAIN_WINDOW, dev)
    n_params = sum(t.numel() for t in optim.tree_leaves(state.params))
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    steps = []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, metrics = trainer.train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        row = {"host_s": time.perf_counter() - t0,
               "device_s": start.elapsed_time(end) / 1e3,
               **{k: float(v) for k, v in metrics.items()}}
        steps.append(row)
        print(f"(y) UMGen_Large step {i + 1}: loss {row['loss']:.4f} (ego "
              f"{row['ego_loss']:.3f} tar {row['tar_loss']:.3f} oar "
              f"{row['oar_loss']:.3f}) grad norm {row['grad_norm']:.3f}; "
              f"{row['device_s']:.3f} s (CUDA events), {row['host_s']:.3f} s "
              "(host clock)")
    res["launches"] = _launches((), flash=False)
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    bf16, f32, model_flops = train_step_work(cfg, 1, TRAIN_WINDOW)
    s = min(r["device_s"] for r in steps[1:])
    res.update(steps=steps, params=n_params, window=TRAIN_WINDOW,
               tflop_bf16=bf16 / 1e12, tflop_f32=f32 / 1e12,
               model_tflop=model_flops / 1e12,
               tflop_s=(bf16 + f32) / (s * 1e12),
               bound_s=bf16 / H100_BF16_FLOPS + f32 / H100_FP32_FLOPS)
    print(f"(y) {n_params / 1e9:.3f} B params; a step executes "
          f"{res['tflop_bf16']:.1f} TFLOP of bf16 products and "
          f"{res['tflop_f32']:.1f} of float32 attention (remat included; the "
          f"model's 3 x forward {res['model_tflop']:.1f}): "
          f"{res['tflop_s']:.1f} TFLOP/s at the faster step's {s:.3f} s, "
          f"against {res['bound_s']:.3f} s at the bf16 and float32 peaks; "
          f"peak device memory {res['max_memory_allocated'] / 2**30:.2f} GiB")
    if not all(math.isfinite(r[k]) for r in steps
               for k in ("loss", "grad_norm")):
        raise AssertionError(f"(y) a step's loss or grad norm is not "
                             f"finite: {steps}")
    if not steps[2]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"(y) the loss did not fall over three steps "
                             f"on one batch: {[r['loss'] for r in steps]}")
    # where a step's time goes: torch.profiler over a fourth step
    res["profile"] = prof = _device_table(
        lambda: trainer.train_step(state, batch))
    print(f"(y) profile of a step: {prof['device_s']:.3f} device s in "
          f"{prof['wall_s']:.3f} s (busy {100 * prof['busy']:.1f}%), "
          f"{prof['launches']} launches; by kind (s, launches): "
          + ", ".join(f"{k} {v[1]:.3f} ({v[0]})"
                      for k, v in prof["kinds"].items()))
    for name, (n, sec) in prof["kernels"].items():
        print(f"      {sec:8.3f}  ({n})  {name[:100]}")
    del state, trainer, batch
    torch.cuda.empty_cache()

    # (2) tiny, float32: the card's step, the CPU's in a child process
    cfg = ModelConfig(use_pallas_attention=False, dtype="float32").scaled(
        "tiny")
    params = init_params(cfg, torch.Generator(dev).manual_seed(1), dev)
    trainer = UMGenTrainer(UMGen(cfg), **kw)
    batch = _train_batch(SequenceLayout(cfg.task), cfg, 3, dev, seed=1)
    job = {"cfg": cfg, "trainer": kw,
           "params": optim.tree_map(lambda t: t.cpu(), params),
           "batch": {k: v.cpu() for k, v in batch.items()}}
    state = trainer.init_state(params)
    t0 = time.perf_counter()
    with vq.float32_products():
        state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    card = {"metrics": {k: v.cpu() for k, v in metrics.items()},
            "params": optim.tree_map(lambda t: t.detach().cpu(),
                                     state.params),
            "opt_state": optim.tree_map(lambda t: t.cpu(), state.opt_state),
            "seconds": time.perf_counter() - t0}
    check = _TrainCardVsCpu(job, card, work_dir)
    del state, trainer, params

    # (3) debug scale: a checkpoint round trip
    cfg = ModelConfig(use_pallas_attention=False).scaled("debug")
    trainer = UMGenTrainer(UMGen(cfg), **kw)
    state = trainer.init_state(init_params(
        cfg, torch.Generator(dev).manual_seed(2), dev))
    batch = _train_batch(SequenceLayout(cfg.task), cfg, TRAIN_WINDOW, dev,
                         seed=2)
    state, _ = trainer.train_step(state, batch)
    path = os.path.join(work_dir, "train_state")
    t0 = time.perf_counter()
    ckpt.save_train_state(path, state)
    res["ckpt_bytes"] = os.path.getsize(path)
    res["ckpt_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ckpt.load_train_state(path, trainer.init_state(init_params(
        cfg, torch.Generator(dev).manual_seed(3), dev)))
    torch.cuda.synchronize()
    res["ckpt_load_s"] = time.perf_counter() - t0
    os.remove(path)
    a, _ = trainer.train_step(state, batch)
    b, _ = trainer.train_step(loaded, batch)
    same = all(torch.equal(x, y) for x, y in zip(
        optim.tree_leaves((a.params, a.opt_state, a.step)),
        optim.tree_leaves((b.params, b.opt_state, b.step))))
    print(f"(y) debug-scale train state ({res['ckpt_bytes'] / 2**30:.2f} "
          f"GiB) saved in {res['ckpt_save_s']:.2f} s, loaded in "
          f"{res['ckpt_load_s']:.2f} s; the next step from each equal bit "
          f"for bit: {same}")
    if not same:
        raise AssertionError("(y) a step from the loaded train state differs "
                             "from the step from the state in memory")
    res["ckpt_round_trip_equal"] = same
    del a, b, state, loaded, trainer
    torch.cuda.empty_cache()

    # (4) the map VQ codec at its published size
    torch.cuda.reset_peak_memory_stats()
    vq_trainer = VQTrainer(vq.MAP_VQ, vq.init_normvq(
        torch.Generator(dev).manual_seed(4), vq.MAP_VQ, dev), 1e-4)
    rng = np.random.default_rng(0)
    vq_steps = []
    for i in range(3):
        x = torch.as_tensor(synthetic_rasters(rng, 2, vq.MAP_VQ.resolution,
                                              vq.MAP_VQ.in_channels),
                            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = vq_trainer.step(x)
        torch.cuda.synchronize()
        vq_steps.append({"s": time.perf_counter() - t0,
                         **{k: float(v) for k, v in m.items()}})
    path = ckpt.save_params(os.path.join(work_dir, "map_final"),
                            vq_trainer.inference_params())
    tokens = rng.integers(0, vq.MAP_VQ.n_embed,
                          (2, math.prod(vq.MapDecoder.grid)))
    maps = vq.MapDecoder(ckpt.load_params(path), device=dev).decode(tokens)
    os.remove(path)
    res["vq"] = {"steps": vq_steps, "max_memory_allocated":
                 torch.cuda.max_memory_allocated(),
                 "decoded": list(maps.shape)}
    print(f"(y) map VQ codec (MAP_VQ), B = 2: losses "
          f"{[round(r['loss'], 4) for r in vq_steps]}, perplexity "
          f"{[round(r['perp'], 1) for r in vq_steps]}, "
          f"{[round(r['s'], 3) for r in vq_steps]} s a step; peak device "
          f"memory {res['vq']['max_memory_allocated'] / 2**30:.2f} GiB; "
          f"MapDecoder from the save: {maps.shape}")
    if not all(math.isfinite(r["loss"]) and r["perp"] >= 1
               for r in vq_steps):
        raise AssertionError(f"(y) VQ training: {vq_steps}")
    if maps.shape != (2,) + VQ_PICTURES["map"] or \
            not np.isfinite(maps).all():
        raise AssertionError(f"(y) MapDecoder on the trained save: "
                             f"{maps.shape}")
    del vq_trainer
    torch.cuda.empty_cache()
    return res, check


VOCAB = {"pose": 1024, "map": 8192, "bbox3d": 1028, "image": 8192}


def _reset_launches():
    from umgen_tpu_torch.ops import decode_kernel as dk
    from umgen_tpu_torch.ops import flash_attention as fa
    from umgen_tpu_torch.ops import gelu as gk
    for counts in (fa.LAUNCHES, dk.LAUNCHES, gk.LAUNCHES):
        for k in counts:
            counts[k] = 0


# what of a kernel was redesigned for Hopper after its first port (the
# `redesigned_in` field of the kernels line; None: the first port's design)
_ATTN_I8 = "the int8 cache's attention on the reference's S-blocks"
_ATTN_I4 = ("the int4 cache's attention on the reference's S-blocks (the "
            "int8 cache's passes, templated on the cache's kind)")
_ATTN_DENSE = ("the dense cache's attention on the reference's S-blocks (the "
               "integer passes' instances)")
_GEMV_W4 = "the staged W4 GEMV"
_GEMV_I8 = ("the staged int8 GEMV (at B·Q <= 2 with the layer norm and "
            "quantization in its blocks)")
REDESIGNED = {
    "flash_attention": "wgmma products, TMA loads by a producer warp",
    "w4": f"{_ATTN_I8}; {_GEMV_W4}", "w4mq": f"{_ATTN_I8}; {_GEMV_W4}",
    **{k: f"{_ATTN_I8}; {_GEMV_I8}"
       for k in ("v5", "v5mq", "v3", "v4", "v6", "v7")},
    "v5i4": f"{_ATTN_I4}; {_GEMV_I8}", "v5mqi4": f"{_ATTN_I4}; {_GEMV_I8}",
    "w4i4": f"{_ATTN_I4}; {_GEMV_W4}", "w4mqi4": f"{_ATTN_I4}; {_GEMV_W4}",
    "v1": f"{_ATTN_DENSE}; {_GEMV_I8}", "v2": f"{_ATTN_DENSE}; {_GEMV_I8}"}


def _kernel_name(kind):
    """v5, w4mqi4, ... → the wrapper's name; v1 is `fused_decode_step`."""
    return "fused_decode_step" if kind == "v1" else \
        f"fused_decode_step_{kind}"


def _launches(decode, flash=True):
    """The kernels' launch counts since the reset.  Flash (unless the path
    has no TAR cascade) and the decode kernels named in `decode` have to
    have launched, and no other kernel."""
    from umgen_tpu_torch.ops import decode_kernel as dk
    from umgen_tpu_torch.ops import flash_attention as fa
    launches = {**fa.LAUNCHES, **dk.LAUNCHES}
    must = (["flash_attention"] if flash else []) \
        + [_kernel_name(k) for k in decode]
    for k in must:
        if launches[k] <= 0:
            raise AssertionError(f"{k} never launched on the main path")
    for k, n in launches.items():
        if k not in must and n:
            raise AssertionError(f"{k} launched {n} times on a path that "
                                 "must not run it")
    return launches


def _check_tokens(out_dir, scenes, frames):
    import numpy as np
    from umgen_tpu_torch.layout import CONTENT_LEN
    outs = _load_tokens(out_dir)
    if len(outs) != scenes:
        raise AssertionError(f"{len(outs)} token files, {scenes} scenes")
    for out in outs:
        for mod, n in VOCAB.items():
            toks = np.asarray(out[mod])
            if toks.shape[-1] != CONTENT_LEN[mod] or toks.shape[1] != frames:
                raise AssertionError(f"{mod}: token shape {toks.shape}")
            if toks.min() < 0 or toks.max() >= n:
                raise AssertionError(f"{mod}: tokens outside [0, {n})")


def phase_rollout(dev, out_dir, tag="c", new_frames=2, flags=(),
                  must=("v5", "v5mq"), B=1, scale="larger"):
    """The bf16-ring slice at UMGen_Large width through the CLI's code
    path: the prefill frame and `new_frames` - 1 cached ones, with the extra
    CLI `flags`; the decode kernels `must` have to launch, and no other.
    Phase c: the int8 OAR cache (v5, v5mq); h: `--oar_kv_dtype int4` (v5i4,
    v5mqi4); j: `--oar_kv_dtype bfloat16` (v2; the pushes run the eager
    body); k: `--oar_kernel 7`, B = 2 (v7, v5mq); l: `--oar_kv_dtype
    float8_e4m3fn` (v2)."""
    return _cli_frames(
        dev, out_dir, ["--infer_task", "video", "--model_scale", scale,
                       "--fused_oar", "--kv_dtype", "bfloat16", "--int8",
                       "decode", "--sample_method", "topk"] + list(flags),
        tag, f"cached rollout, --model_scale {scale}, B={B}, "
        f"{' '.join(flags) or 'int8 OAR cache'} (first frame = prefill + "
        "decode)", must, new_frames, B)[0]


def phase_slice_v1(dev, out_dir):
    """slice-v1: the bf16-ring slice with int8-quantized but UNPACKED OAR
    weights on a bfloat16 OAR cache, through Generator / SceneRunner — the
    API path on which `Rollout.oar_step` reaches `fused_decode_step` (v1).
    Full width, the 24-layer scale, B = 1, the prefill frame; flash and v1
    must launch, no other kernel (the pushes run the eager body)."""
    import torch
    from umgen_tpu_torch.config import InferConfig
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen, build_buffers
    from umgen_tpu_torch.params import init_params
    from umgen_tpu_torch.runtime.quantize import quantize_params_int8
    from umgen_tpu_torch.tools import evaluate
    from umgen_tpu_torch.tools.harness import SceneRunner
    args = evaluate.build_parser().parse_args([
        "--infer_task", "video", "--model_scale", "stander", "--fused_oar",
        "--kv_dtype", "bfloat16", "--oar_kv_dtype", "bfloat16", "--debug",
        "--synthetic_data", "1", "--max_scenes", "1",
        "--set_num_new_frames", "1", "--sample_method", "topk",
        "--output_path", out_dir, "--device", str(dev), "--save_video",
        "false"])
    evaluate.check_args(args)
    cfg = evaluate.config_from_args(args)
    pipeline = ScenePipeline()
    infer_cfg = InferConfig.for_task(args.infer_task, args.set_num_new_frames,
                                     batch_size=1, seed=args.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    params = quantize_params_int8(init_params(
        cfg, g, dev, buffers=build_buffers(cfg, pipeline, device=dev)))
    if "oar_packed" in params:
        raise AssertionError("slice-v1 runs on unpacked OAR weights")
    gen = Generator(UMGen(cfg), params, seed=args.seed, device=dev)
    runner = SceneRunner(gen, infer_cfg, output_path=out_dir,
                         save_video=False)
    _reset_launches()
    t0 = time.perf_counter()
    evaluate.run_dataset(args, runner, infer_cfg, pipeline)
    secs = time.perf_counter() - t0
    launches = _launches(("v1",))
    _check_tokens(out_dir, scenes=1, frames=21)
    frame_s = list(gen.frame_seconds)
    print(f"(l) slice-v1, --model_scale stander, B=1, unpacked int8 OAR "
          f"weights on a bfloat16 cache: per-frame seconds "
          f"{', '.join(f'{s:.2f}' for s in frame_s)}; launches {launches}; "
          f"whole run {secs:.1f} s")
    return {"frame_seconds": frame_s, "launches": launches, "seconds": secs}


class _FrameSplit:
    """While it is entered: times the OAR decode of each frame
    (`Rollout._finish_frame`, with a synchronize on both sides) and stamps
    the host clock at each single-token eager step
    (`Rollout._oar_step_eager`)."""

    def __enter__(self):
        import torch
        from umgen_tpu_torch.models.rollout import Rollout
        self.oar_s, self.eager_t = [], []
        self.real = finish, eager = (Rollout._finish_frame,
                                     Rollout._oar_step_eager)

        def timed_finish(ro, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = finish(ro, *a, **k)
            torch.cuda.synchronize()
            self.oar_s.append(time.perf_counter() - t0)
            return out

        def stamped_eager(ro, params, x, *a, **k):
            if x.shape[1] == 1:
                self.eager_t.append(time.perf_counter())
            return eager(ro, params, x, *a, **k)

        Rollout._finish_frame = timed_finish
        Rollout._oar_step_eager = stamped_eager
        return self

    def __exit__(self, *exc):
        from umgen_tpu_torch.models.rollout import Rollout
        Rollout._finish_frame, Rollout._oar_step_eager = self.real

    def eager_ms(self, first=500, last=1499):
        """Wall ms a step over single-token eager steps first..last of the
        first frame (the host's pace; the steps do not wait on the card)."""
        t = self.eager_t
        return 1e3 * (t[last] - t[first]) / (last - first)


def _cli_frames(dev, out_dir, argv, tag, what, must, frames, B=1):
    """Run the CLI's code path (`evaluate.run`) on `argv` with every launch
    count reset just before; check the tokens and that flash and the decode
    kernels `must` launched, and no other.  Returns the report (per-frame
    seconds, each frame's OAR seconds and the rest, peak device memory,
    launches), the Generator and the _FrameSplit."""
    import torch
    from umgen_tpu_torch.tools import evaluate
    args = evaluate.build_parser().parse_args(
        argv + ["--debug", "--synthetic_data", str(B), "--max_scenes",
                str(B), "--batch_size", str(B), "--set_num_new_frames",
                str(frames), "--output_path", out_dir, "--device", str(dev),
                "--save_video", "false"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _FrameSplit() as split:
        _reset_launches()
        t0 = time.perf_counter()
        _, gen = evaluate.run(args)
        secs = time.perf_counter() - t0
        launches = _launches(must)
    peak = torch.cuda.max_memory_allocated()
    _check_tokens(out_dir, scenes=B, frames=20 + frames)
    frame_s = list(gen.frame_seconds)
    rest = [f - o for f, o in zip(frame_s, split.oar_s)]
    tar_b, ring_b = _tar_bytes(gen, B)
    print(f"({tag}) {what}: per-frame seconds "
          f"{', '.join(f'{s:.2f}' for s in frame_s)}, of which the OAR "
          f"decode {', '.join(f'{s:.2f}' for s in split.oar_s)} and ego + "
          f"TAR {', '.join(f'{s:.2f}' for s in rest)}; peak device memory "
          f"{peak / 2**30:.2f} GiB; TAR-family weights "
          f"{tar_b / 2**30:.3f} GiB, rings {ring_b / 2**30:.3f} GiB; "
          f"launches {launches}; whole run {secs:.1f} s")
    return {"frame_seconds": frame_s, "oar_seconds": split.oar_s,
            "tar_seconds": rest, "max_memory_allocated": peak,
            "tar_weight_bytes": tar_b, "ring_bytes": ring_b,
            "launches": launches, "seconds": secs}, gen, split


def _tar_bytes(gen, B):
    """(bytes of the TAR-family weights — runtime.quantize.TAR_STACK_KEYS —
    in the run's params, bytes of the B scenes' ego and TAR rings of its
    configuration: built on the meta device, nothing allocated)."""
    from umgen_tpu_torch.runtime.quantize import TAR_STACK_KEYS

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, (tuple, list)):
            return sum(nbytes(v) for v in t)
        return t.numel() * t.element_size() if hasattr(t, "numel") else 0

    rings = {} if gen.model.config.tar_mode == "recompute" else \
        gen.model.init_tar_cache(B, device="meta")
    return (nbytes({k: gen.params[k] for k in TAR_STACK_KEYS
                    if k in gen.params}), nbytes(rings))


# phase o's depth: its TAR and OAR stacks cut to 3 layers (the CLI's
# smallest named scale has 24; at 6 a whole run with phase tp took 1094 s),
# the map / box / ego stacks as they are; phases p, q, u and z too
DEFAULT_RUN_LAYERS = 3


@contextlib.contextmanager
def _depth(layers):
    """While entered, the CLI's config has its TAR and OAR stacks cut to
    `layers` (the rest of its code path as it is)."""
    from umgen_tpu_torch.tools import evaluate
    config_from_args = evaluate.config_from_args
    evaluate.config_from_args = lambda args: config_from_args(args).replace(
        n_tar_layer=layers, n_oar_layer=layers)
    try:
        yield
    finally:
        evaluate.config_from_args = config_from_args


def _flash_a_frame(cfg):
    """Flash launches of a full-window TAR pass (a prefill or recompute
    frame) and of a cached one: two a TAR-family block."""
    return 2 * (cfg.n_tar_layer + cfg.n_map_tar_layer + cfg.n_box_tar_layer
                + cfg.n_ego_tar_layer)


def phase_default_run(dev, out_dir):
    """(o) the reference CLI's default run: no flag but the run's size, its
    TAR and OAR stacks cut to DEFAULT_RUN_LAYERS (the CLI's config with the
    depth replaced, the rest of its code path as it is)."""
    with _depth(DEFAULT_RUN_LAYERS):
        res, gen, split = _cli_frames(
            dev, out_dir, ["--model_scale", "stander"], "o", "the reference "
            f"CLI's default run at {DEFAULT_RUN_LAYERS} TAR / OAR layers "
            "(B=1, fp8 rings, the unfused decode on an fp8 OAR cache, int8 "
            "decode weights, top-k)", must=(), frames=1)
    cfg = gen.model.config
    want = {"tar_mode": "temporal_cache", "tar_cache_dtype": "float8_e4m3fn",
            "oar_cache_dtype": "float8_e4m3fn", "fused_oar_kernel": False,
            "n_oar_layer": DEFAULT_RUN_LAYERS, "n_embd": 768,
            "sample_method": "topk"}
    got = {k: getattr(cfg, k) for k in want}
    if got != want or "oar_packed" in gen.params:
        raise AssertionError(f"default run {got}, expected {want}, unpacked")
    res["eager_steps"] = len(split.eager_t)
    res["eager_step_ms"] = split.eager_ms()
    print(f"(o) {res['eager_steps']} single-token eager steps, "
          f"{res['eager_step_ms']:.2f} ms a step (host clock, steps "
          "500-1499)")
    # where an eager step's time goes: 20 steps at cache_len 1100
    import torch
    ro = gen.rollout
    kv_k, kv_v = ro.init_kv(1, device=dev)
    x = torch.randn(1, 1, cfg.n_embd, device=dev).to(torch.bfloat16)
    prof = _kernel_profile(
        lambda: ro._oar_step_eager(gen.params, x, kv_k, kv_v, 1100), 20)
    prof["launches_per_step"] = sum(
        r["launches_per_call"] for r in prof["kernels"].values())
    prof["kernels"] = dict(list(prof["kernels"].items())[:12])
    print(f"(o) profile of 20 eager steps at cache_len 1100: "
          f"{prof['device_ms'] / 20:.3f} device ms a step in "
          f"{prof['wall_ms'] / 20:.2f} ms (busy {100 * prof['busy']:.1f}%), "
          f"{prof['launches_per_step']:.0f} launches a step")
    res["eager_profile"] = prof
    return res


def phase_recompute(dev, out_dir):
    """(p) recompute at full width, the TAR / OAR stacks at
    DEFAULT_RUN_LAYERS (cut from 36), two frames."""
    with _depth(DEFAULT_RUN_LAYERS):
        res, gen, _ = _cli_frames(
            dev, out_dir, ["--tar_mode", "recompute", "--fused_oar",
                           "--kv_dtype", "bfloat16", "--sample_method",
                           "greedy"], "p", "recompute, UMGen_Large width, "
            f"{DEFAULT_RUN_LAYERS} TAR / OAR layers, B=1, the whole window "
            "through every TAR stack", must=("v5", "v5mq"), frames=2)
    want = _flash_a_frame(gen.model.config)
    if res["launches"]["flash_attention"] != want * 2:
        raise AssertionError(f"recompute launched flash "
                             f"{res['launches']['flash_attention']} times "
                             f"in two frames, expected {want} a frame")
    res["tokens"] = _load_tokens(out_dir)[0]
    return res


def phase_refresh(dev, out_dir, recompute_tokens):
    """(q) ring refresh on fp8 rings, two frames: the second one refreshes
    the rings; p's depth."""
    import numpy as np
    with _depth(DEFAULT_RUN_LAYERS):
        res, gen, _ = _cli_frames(
            dev, out_dir, ["--fused_oar", "--tar_cache_refresh", "1",
                           "--sample_method", "greedy"], "q",
            "ring refresh every frame, UMGen_Large width, "
            f"{DEFAULT_RUN_LAYERS} TAR / OAR layers, B=1, fp8 rings, int8 "
            "OAR cache", must=("v5", "v5mq"), frames=2)
    if gen.refreshes != 1 or gen.model.config.tar_cache_dtype != \
            "float8_e4m3fn":
        raise AssertionError(f"{gen.refreshes} refreshes on "
                             f"{gen.model.config.tar_cache_dtype} rings, "
                             "expected one on fp8 rings")
    res["refreshes"] = gen.refreshes
    mine = _load_tokens(out_dir)[0]
    res["equal_to_recompute"] = {}
    for frame in (20, 21):
        a = np.concatenate([np.asarray(mine[m])[:, frame].reshape(-1)
                            for m in VOCAB])
        b = np.concatenate([np.asarray(recompute_tokens[m])[:, frame]
                            .reshape(-1) for m in VOCAB])
        res["equal_to_recompute"][frame - 19] = float((a == b).mean())
    print(f"(q) share of tokens equal to (p)'s recompute stream, by frame "
          f"(a record, not a gate): {res['equal_to_recompute']}")
    return res


SLICE_FLAGS = ["--infer_task", "video", "--model_scale", "larger",
               "--fused_oar", "--kv_dtype", "bfloat16", "--int8", "decode"]
# speculative against sequential greedy streams in bf16: a stream may leave
# the other only where the sequential decision's top-2 logits lie within
# this many bf16 ulps of the top one: through one layer (the card test at
# debug scale) tests/test_torch_slice.py's GAP_ULPS; through 36 a Q = 8
# verify's h drifts from a Q = 1 step's as phase b's 36-layer readings do
# (up to 6.5% of its scale, int8 requantization flips compounding layer by
# layer; DECODE_RTOL_36), and the logits with it: 16 ulps (2^-4).  This
# bound was set after the first full-depth reading (7 ulps), from that
# spread.  Only the prefill frame is held to it: the cached frame reads a
# window holding each run's own first frame.  Phase u runs DEFAULT_RUN_LAYERS
# (cut from 36): fewer layers drift less, and the bound stays
SPEC_GAP_ULPS = 4
SPEC_GAP_ULPS_36 = 16


class _GreedyLog:
    """A greedy sampler that keeps each decision's top-2 logits [B, 2]."""

    def __init__(self):
        self.top2 = []

    def __call__(self, generator, logits):
        import torch
        self.top2.append(torch.topk(logits.float(), 2, dim=-1).values)
        return torch.argmax(logits, dim=-1)


# a frame's decisions: the ego action, 1024 map, 660 × 3 box and 512 image
FRAME_DECISIONS = 1 + 1024 + 3 * 660 + 512


def spec_divergences(mine, ref, top2, frames, first=20):
    """Speculative tokens `mine` against the sequential run's `ref` (token
    pickles) and its decisions' top-2 logits (3517 a frame: the ego
    action, 1024 map, 660 × (OAR, control, TAR) box, 512 image decisions).
    Per frame: the share of equal tokens, the runs of differing positions
    of each segment, and each run's first position's top-2 gap in bf16 ulps
    (the box positions' smaller of the OAR and TAR decisions' gaps)."""
    import numpy as np
    # scene 0's top-2 of each decision (the ego action's first token)
    gaps = np.stack([t.reshape(-1, 2)[0].cpu().numpy() for t in top2])
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(gaps[:, 0]),
                                              2.0 ** -3))) - 7)
    gap_ulps = (gaps[:, 0] - gaps[:, 1]) / ulp
    per_frame = FRAME_DECISIONS
    out = {}
    for f in range(frames):
        base = f * per_frame
        decision = {"map": base + 1 + np.arange(1024),
                    "bbox3d": base + 1025 + 3 * np.arange(660),
                    "image": base + 1025 + 1980 + np.arange(512)}
        equal, starts = [], []
        for m, idx in decision.items():
            a = np.asarray(mine[m])[0, first + f]
            b = np.asarray(ref[m])[0, first + f]
            diff = a != b
            equal.append(~diff)
            g = gap_ulps[idx]
            if m == "bbox3d":                  # the OAR or the TAR decision
                g = np.minimum(g, gap_ulps[idx + 2])
            run0 = diff & ~np.concatenate([[False], diff[:-1]])
            starts += [(m, int(p), float(g[p])) for p in np.nonzero(run0)[0]]
        out[f + 1] = {"equal": float(np.concatenate(equal).mean()),
                      "runs": len(starts),
                      "worst_run_start": max(starts, key=lambda r: r[2],
                                             default=None)}
    return out


def phase_speculative(dev, out_dir, seq_dir, K=8, frames=2):
    """(u) speculative decoding at full width, the TAR / OAR stacks at
    DEFAULT_RUN_LAYERS (cut from 36): the bf16-ring slice's flags,
    greedy, `--speculative_k 8`, B = 1, the prefill frame and a cached one
    through the CLI's code path.  Every verify chunk must be
    one v5mq launch at Q = K (launches = chunks + 3 pushes a frame) and no
    other decode kernel may launch; then the same run without speculation
    (v5, v5mq), its prefill frame only (the cached frame reads a window
    holding each run's own first frame).  Greedy bf16 logits tie often,
    and a Q = K verify sums in another order than a Q = 1 step, so the two
    streams part at near ties and join again: every run of positions where
    the prefill frames differ must start at a decision of the sequential
    run whose top-2 logits lie within SPEC_GAP_ULPS_36; the share of equal
    tokens is printed."""
    from umgen_tpu_torch.models import rollout as rollout_mod
    from umgen_tpu_torch.ops import decode_kernel as dk
    flags = SLICE_FLAGS + ["--sample_method", "greedy"]
    calls = []
    real = dk.fused_decode_step_v5mq

    def counted(packed, x, *a, **k):
        calls.append(x.shape[1])
        return real(packed, x, *a, **k)

    dk.fused_decode_step_v5mq = counted
    try:
        with _depth(DEFAULT_RUN_LAYERS):
            res, gen, _ = _cli_frames(
                dev, out_dir, flags + ["--speculative_k", str(K)], "u",
                f"speculative decoding, K={K}, greedy, UMGen_Large width, "
                f"{DEFAULT_RUN_LAYERS} TAR / OAR layers, B=1",
                must=("v5mq",), frames=frames)
    finally:
        dk.fused_decode_step_v5mq = real
    chunks, acc = gen.spec_chunks, gen.spec_accepted
    n = res["launches"]["fused_decode_step_v5mq"]
    if not (calls.count(K) == chunks == n - 3 * frames
            and len(calls) == n and chunks >= 2196 * frames // K):
        raise AssertionError(f"{chunks} chunks, {n} v5mq launches, Q of "
                             f"the calls {sorted(set(calls))}: every verify "
                             f"chunk must be one v5mq launch at Q={K}")
    log, make = _GreedyLog(), rollout_mod.make_sampler
    rollout_mod.make_sampler = lambda *a, **k: log
    try:
        with _depth(DEFAULT_RUN_LAYERS):
            seq, _, _ = _cli_frames(dev, seq_dir, flags, "u-seq", "the same "
                                    "run without speculation, the prefill "
                                    "frame", must=("v5", "v5mq"), frames=1)
    finally:
        rollout_mod.make_sampler = make
    div = spec_divergences(_load_tokens(out_dir)[0], _load_tokens(seq_dir)[0],
                           log.top2, 1)
    res.update(chunks=chunks, accepted=acc, drafts_per_chunk=acc / chunks,
               v5mq_launches_per_frame=n / frames, against_sequential=div,
               sequential=seq)
    print(f"(u) {chunks} verify chunks, {acc} drafts accepted "
          f"({acc / chunks:.3f} a chunk), {n / frames:.0f} v5mq launches a "
          f"frame; the prefill frame against the sequential greedy run's "
          f"(share of equal tokens, runs of differing positions, the run "
          f"start with the widest top-2 gap: segment, position, bf16 ulps): "
          f"{div[1]}")
    far = div[1]["worst_run_start"]
    if far and far[2] > SPEC_GAP_ULPS_36:
        raise AssertionError(f"the speculative stream leaves the sequential "
                             f"one where its top-2 gap is no near tie: {far}")
    return res


def phase_tar_options(dev, out_dir, scale="larger"):
    """(v) W4 TAR weights on int2 rings, full width: `--tar_w4 --kv_dtype
    int2 --fused_oar`, B = 2, the full-window prefill (the rings' channel
    equalizers frozen from it) and a cached frame through the CLI's code
    path; flash, v5 and v5mq launch."""
    res, gen, _ = _cli_frames(
        dev, out_dir, ["--infer_task", "video", "--model_scale", scale,
                       "--fused_oar", "--kv_dtype", "int2", "--tar_w4",
                       "--int8", "decode", "--sample_method", "topk"], "v",
        f"W4 TAR weights, int2 rings, --model_scale {scale}, B=2",
        must=("v5", "v5mq"), frames=2, B=2)
    tar = gen.params["tar"]["ta"]["qkv"]
    if gen.model.config.tar_cache_dtype != "int2" or "wq4" not in tar:
        raise AssertionError("phase v must run group-int4 TAR weights on "
                             "int2 rings")
    return res


_REF_NAMES = {"ln1": "ln_1", "ln2": "ln_2", "ln3": "ln_3", "ln4": "ln_4",
              "ln5": "ln_5", "ln6": "ln_6", "sa1": "spatial_attn_1",
              "ta": "temporal_attn", "sa2": "spatial_attn_2",
              "attn": "temporal_attn", "qkv": "c_attn", "proj": "c_proj",
              "fc": "c_fc", "q": "q_attn", "k": "k_attn", "v": "v_attn"}
_REF_STACKS = {"tar": "TAR", "oar": "OAR", "ego_tar": "ego_tar",
               "ego_ca": "ego_cross_attn", "map_tar": "map_tar",
               "box_tar": "box_tar"}


def export_reference_state_dict(params):
    """The port's params → a state dict in the reference's names and layout
    (what UMGen_Large.pt holds under its DeepSpeed wrapper: torch's [out,
    in] linear weights, one entry a layer), on the CPU in the params'
    dtype.  The inverse of runtime.torch_import.import_umgen; the buffers
    and the relative temporal-PE table are not in the reference's."""
    sd = {}

    def emit(tree, name, stack=None, i=None):
        if set(tree) <= {"w", "b"}:                    # a linear or a norm
            w = tree["w"] if i is None else tree["w"][i]
            sd[f"{name}.weight"] = (w.t() if w.dim() == 2 else w
                                    ).contiguous().cpu()
            if "b" in tree:
                b = tree["b"] if i is None else tree["b"][i]
                sd[f"{name}.bias"] = b.contiguous().cpu()
            return
        for k, v in tree.items():
            ref = "mlp1" if (stack, k) == ("ego_ca", "mlp") else \
                _REF_NAMES.get(k, k)
            emit(v, f"{name}.{ref}", stack, i)

    for k, v in params.items():
        if k in ("buffers", "tpe_rel"):
            continue
        if k in _REF_STACKS:
            for i in range(v["ln1"]["w"].shape[0]):
                emit(v, f"transformer.{_REF_STACKS[k]}.{i}", k, i)
        elif not isinstance(v, dict):                  # an embedding table
            sd[f"transformer.{k}.weight"] = v.contiguous().cpu()
        else:
            emit(v, k if k.endswith("_mlp_pre") else f"transformer.{k}")
    return sd


def _control_scene(layout, gt_frames):
    """One synthetic control pkl (data.synthetic.make_control_scene: 13
    conditioning frames, the ego trajectory and one controlled agent), its
    dataset tokens extended by a GT continuation of `gt_frames` frames for
    MMD to score against."""
    import numpy as np
    from umgen_tpu_torch.data.synthetic import (make_control_scene,
                                                make_token_batch)
    scene = make_control_scene(layout, seed=7)
    more = make_token_batch(layout, T=gt_frames, B=1, seed=8)
    scene["dataset_token"] = {
        m: np.concatenate([v, more[m][0].astype(v.dtype)])
        for m, v in scene["dataset_token"].items()}
    return scene


def phase_control(dev, out_dir, work_dir, frames=2):
    """(s) the control task at UMGen_Large width and depth, through the
    CLI's code path (`evaluate.run`, `InferConfig.for_task` cut to `frames`
    generated frames) on a
    checkpoint: seeded weights exported in the reference's format
    (`torch.save`, DeepSpeed's {"module": ...} wrapper) and read back by
    `--ckpt_dir`; B = 1, `--fused_oar --kv_dtype bfloat16 --int8 decode
    --sample_method greedy`, one control pkl under data/controlled_scenes of
    the working directory.  The generated pose tokens must be the pkl's
    trajectory, every token inside its vocabulary, flash, v5 and v5mq (no
    other decode kernel) must launch, the collision rate and MMD must be
    finite; and the same scene through `SceneRunner.run_scene` on the
    weights in memory (cast as the importer casts them) must give the
    same tokens."""
    import dataclasses
    import pickle

    import numpy as np
    import torch
    from umgen_tpu_torch.config import InferConfig
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen, build_buffers
    from umgen_tpu_torch.params import init_params, torch_dtype
    from umgen_tpu_torch.runtime.torch_import import _cast
    from umgen_tpu_torch.tools import evaluate
    from umgen_tpu_torch.tools.harness import SceneRunner
    run_dir = os.path.join(work_dir, "control_run")
    ckpt = os.path.join(run_dir, "UMGen_Large.pt")
    args = evaluate.build_parser().parse_args([
        "--infer_task", "control", "--model_scale", "larger", "--fused_oar",
        "--kv_dtype", "bfloat16", "--int8", "decode", "--sample_method",
        "greedy", "--ckpt_dir", ckpt, "--output_path", out_dir, "--device",
        str(dev), "--save_video", "false"])
    cfg = evaluate.config_from_args(args)
    pipeline = ScenePipeline()

    def seeded():
        g = torch.Generator(device=dev)
        g.manual_seed(11)
        return init_params(cfg, g, dev, buffers=build_buffers(
            cfg, pipeline, device=dev))

    params = seeded()
    n_weights = sum(t.numel() for k, v in params.items() if k != "buffers"
                    for t in _tensors(v))
    os.makedirs(os.path.join(run_dir, evaluate.CONTROL_ROOT))
    t0 = time.perf_counter()
    torch.save({"module": export_reference_state_dict(params)}, ckpt)
    save_s = time.perf_counter() - t0
    del params           # rebuilt from its seed for the in-memory run
    torch.cuda.empty_cache()
    scene = _control_scene(UMGen(cfg).layout, gt_frames=frames)
    with open(os.path.join(run_dir, evaluate.CONTROL_ROOT,
                           "control_scene_000.pkl"), "wb") as f:
        pickle.dump(scene, f)

    load_s = []
    real_build = evaluate.build_params

    def timed_build(*a, **k):
        t = time.perf_counter()
        out = real_build(*a, **k)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t)
        return out

    for_task = InferConfig.for_task

    def cut(*a, **k):
        return dataclasses.replace(for_task(*a, **k), num_new_frames=frames)

    cwd = os.getcwd()
    os.chdir(run_dir)
    evaluate.build_params = timed_build
    InferConfig.for_task = staticmethod(cut)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _FrameSplit() as split:
            _reset_launches()
            t0 = time.perf_counter()
            runner, gen = evaluate.run(args)
            secs = time.perf_counter() - t0
            launches = _launches(("v5", "v5mq"))
    finally:
        os.chdir(cwd)
        evaluate.build_params = real_build
        InferConfig.for_task = staticmethod(for_task)
    peak = torch.cuda.max_memory_allocated()
    [out] = _load_tokens(out_dir)
    T = 13 + frames
    for mod, n in VOCAB.items():
        toks = np.asarray(out[mod])
        if toks.shape[:2] != (1, T) or toks.min() < 0 or toks.max() >= n:
            raise AssertionError(f"(s) {mod}: tokens {toks.shape} outside "
                                 f"[0, {n}) or not {T} frames")
    if not np.array_equal(out["pose"][0, 13:],
                          scene["control_dict"]["pose"][:frames]):
        raise AssertionError("(s) the generated pose tokens are not the "
                             "control pkl's trajectory")
    collision = runner.box_overlap.average()
    mmd = runner.mmd.average()
    if not (all(math.isfinite(x) for x in collision)
            and runner.mmd.scores["posi"]
            and all(math.isfinite(x) for x in mmd.values())):
        raise AssertionError(f"(s) collision rate {collision}, MMD {mmd}")
    frame_s, oar_s = list(gen.frame_seconds), list(split.oar_s)
    del runner, gen
    torch.cuda.empty_cache()

    # the importer's end-to-end check: the seeded weights in memory, cast
    # as load_umgen_checkpoint casts every floating leaf, through
    # SceneRunner
    mem = evaluate.prepare_params(args, cfg,
                                  _cast(seeded(), torch_dtype(cfg.dtype)))
    direct = SceneRunner(
        Generator(UMGen(cfg), mem, seed=args.seed, device=dev),
        cut("control"),
        output_path=os.path.join(run_dir, "direct"), pipeline=pipeline,
        save_video=False)
    mine = direct.run_scene(scene, control_test=True)
    same = all(np.array_equal(mine[m], out[m]) for m in VOCAB)
    res = {"weights": n_weights, "checkpoint_bytes": os.path.getsize(ckpt),
           "save_seconds": save_s, "load_seconds": load_s[0],
           "frame_seconds": frame_s, "oar_seconds": oar_s,
           "tar_seconds": [f - o for f, o in zip(frame_s, oar_s)],
           "max_memory_allocated": peak, "launches": launches,
           "seconds": secs, "collision_rate": collision, "mmd": mmd,
           "tokens_equal_in_memory": same}
    print(f"(s) control, UMGen_Large ({n_weights / 1e9:.3f} B weights), B=1, "
          f"on an imported checkpoint ({res['checkpoint_bytes'] / 2**30:.2f} "
          f"GiB): saved in {save_s:.1f} s, loaded and prepared in "
          f"{load_s[0]:.1f} s; per-frame seconds "
          f"{', '.join(f'{x:.2f}' for x in frame_s)}, of which the OAR "
          f"decode {', '.join(f'{x:.2f}' for x in oar_s)}; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}; collision "
          f"rate {collision}, MMD {mmd}; tokens equal to the in-memory "
          f"weights' run: {same}; whole run {secs:.1f} s")
    if not same:
        raise AssertionError("(s) the imported checkpoint's rollout differs "
                             "from the in-memory weights' rollout")
    os.remove(ckpt)
    return res


def _tensors(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _tensors(v)
    else:
        yield tree


def phase_step_loops(dev, cfg, packs, steps=64, start=1000, B=2):
    """64 single-token steps from cache_len 1000, full width and depth,
    B = 2, on one random cache and one input a step: `Rollout.oar_step` on
    caller-built 5-D int8 caches with pack_fused's blocks (v3) and with the
    six-stream ones (v4), and `fused_decode_step_v6` on flat caches, each
    against `Rollout.oar_step` on flat caches (v5).  v3 and v4: ln_oar(h) of
    every step and the caches at the end equal v5's bit for bit.  v6: the
    first step's h equals v5's and layer 0's new rows stay within one grid
    step; its other rows, from float32, sit up to a grid step from v5's and
    are attended by the later steps, whose h then drifts from v5's as the
    re-quantization flips compound through 36 layers — recorded, and held to
    twice DECODE_RTOL_36, which only a gross fault exceeds."""
    import torch
    from umgen_tpu_torch.models import modules as nn
    from umgen_tpu_torch.models.rollout import Rollout
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.ops import decode_kernel as dk
    L, d, H = cfg.n_oar_layer, cfg.n_embd, cfg.n_head
    S = 2208
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    ro = Rollout(UMGen(cfg.replace(fused_oar_kernel=True,
                                   oar_cache_dtype="int8",
                                   tar_mode="temporal_cache")))
    ln = {"w": (1 + 0.1 * torch.randn(d, generator=g, device=dev)
                ).to(torch.bfloat16)}
    cache = _random_cache(g, dev, False, L, B, S, d, H)
    xs = torch.randn(steps, B, 1, d, generator=g, device=dev
                     ).to(torch.bfloat16)

    def loop(kind):
        packed = packs["v4" if kind == "v4" else "v5"]
        params = {"oar": packs["qoar"], "ln_oar": ln, "oar_packed": packed}
        kv = [t.clone() for t in cache]
        if kind in ("v3", "v4"):
            kv = [t.view(L, B, S, H, d // H) for t in kv]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = []
        for i in range(steps):
            if kind == "v6":
                h = nn.layer_norm(ln, dk.fused_decode_step_v6(
                    packed, xs[i], *kv, start + i, n_head=H)[0])
            else:
                h = ro.oar_step(params, xs[i], *kv, start + i)[0]
            hs.append(h)
        torch.cuda.synchronize()
        return torch.stack(hs), [t.reshape(L, B, S, d) for t in kv], \
            time.perf_counter() - t0

    _reset_launches()
    h5, kv5, s5 = loop("v5")
    res = {"steps": steps, "B": B, "v5_seconds": s5}
    new = slice(start, start + steps)
    for kind in ("v3", "v4", "v6"):
        h, kv, secs = loop(kind)
        same_h = torch.equal(h, h5)
        same_kv = all(torch.equal(a, b) for a, b in zip(kv, kv5))
        rel = ((h.float() - h5.float()).abs().amax(dim=(1, 2, 3))
               / h5.float().abs().amax(dim=(1, 2, 3))).max().item()
        drow0 = max((a[0, :, new].int() - b[0, :, new].int()).abs().max()
                    .item() for a, b in zip(kv, kv5))
        first = torch.equal(h[0], h5[0])
        res[kind] = {"seconds": secs, "h_equal_v5": same_h,
                     "caches_equal_v5": same_kv, "h_rel_err_max": rel,
                     "first_step_h_equal_v5": first,
                     "layer0_rows_max_steps_from_v5": drow0}
        print(f"(m) {steps} steps of {kind} from cache_len {start}, B={B}: "
              f"{secs:.2f} s (v5 {s5:.2f} s); h equal to v5's at every step: "
              f"{same_h} (first step: {first}; max rel err {rel:.3g}); "
              f"caches equal: {same_kv}; layer 0's new rows at most {drow0} "
              "steps from v5's")
        if kind == "v6":
            ok = first and math.isfinite(rel) \
                and rel <= 2 * DECODE_RTOL_36 and drow0 <= 1
        else:
            ok = same_h and same_kv
        if not ok:
            raise AssertionError(f"step loop of {kind} against v5: "
                                 f"{res[kind]}")
    res["launches"] = _launches(("v5", "v3", "v4", "v6"), flash=False)
    want = {_kernel_name(k): steps for k in ("v5", "v3", "v4", "v6")}
    got = {k: res["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"step loops launched {got}, expected {want}")
    return res


SERVING_FLAGS = [
    "--infer_task", "video", "--model_scale", "larger", "--fused_oar",
    "--kv_dtype", "int4", "--int8", "all", "--chunked_prefill",
    "--tar_cache_window", "8", "--debug", "--synthetic_data", "10",
    "--max_scenes", "10", "--set_num_new_frames", "1", "--batch_size", "10",
    "--sample_method", "topk", "--save_video", "false"]


def phase_serving(dev, out_dir, tag="e", oar_int4=False):
    """The JAX bench's serving configuration (bench.py:150-190, 254-360)
    at UMGen_Large width, B = 10, through Generator / SceneRunner; the OAR
    cache int8 (phase e: w4, w4mq) or int4 (phase g: w4i4, w4mqi4)."""
    import torch
    from umgen_tpu_torch.config import InferConfig
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.models.umgen import UMGen, build_buffers
    from umgen_tpu_torch.ops import gelu as gk
    from umgen_tpu_torch.tools import evaluate
    from umgen_tpu_torch.tools.harness import SceneRunner
    args = evaluate.build_parser().parse_args(
        SERVING_FLAGS + ["--output_path", out_dir, "--device", str(dev)]
        + (["--oar_kv_dtype", "int4"] if oar_int4 else []))
    evaluate.check_args(args)
    cfg = evaluate.config_from_args(args)
    want = {"tar_cache_dtype": "int4",
            "oar_cache_dtype": "int4" if oar_int4 else "int8",
            "fused_oar_kernel": True, "chunked_prefill": True,
            "tar_cache_window": 8, "n_oar_layer": 36, "n_embd": 768}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise AssertionError(f"serving configuration {got}, expected {want}")
    pipeline = ScenePipeline()
    infer_cfg = InferConfig.for_task(args.infer_task, args.set_num_new_frames,
                                     batch_size=args.batch_size,
                                     seed=args.seed)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    t0 = time.perf_counter()
    params = evaluate.serving_params(
        cfg, g, dev, buffers=build_buffers(cfg, pipeline, device=dev))
    setup_s = time.perf_counter() - t0
    gen = Generator(UMGen(cfg), params, seed=args.seed, device=dev)
    runner = SceneRunner(gen, infer_cfg, output_path=out_dir,
                         save_video=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    evaluate.run_dataset(args, runner, infer_cfg, pipeline)
    secs = time.perf_counter() - t0
    launches = _launches(("w4i4", "w4mqi4") if oar_int4 else ("w4", "w4mq"))
    gelu_launches = gk.LAUNCHES["gelu"]
    if gelu_launches <= 0:
        raise AssertionError("the GELU kernel never launched on the main path")
    peak = torch.cuda.max_memory_allocated()
    _check_tokens(out_dir, scenes=10, frames=21)
    [timing] = runner.timings
    frame_s = list(gen.frame_seconds)
    print(f"({tag}) serving configuration, UMGen_Large, B=10, 8-frame int4 "
          f"rings, chunked prefill of 20 frames, W4A8 OAR, "
          f"{'int4' if oar_int4 else 'int8'} OAR cache: per-frame seconds "
          f"{', '.join(f'{s:.2f}' for s in frame_s)} (first = chunked "
          f"prefill + decode); {timing['frames_per_sec']:.4f} frames/s over "
          f"{timing['scenes']} scenes x {timing['frames']} frames; peak "
          f"device memory {peak / 2**30:.2f} GiB; launches {launches}; "
          f"weights {setup_s:.1f} s, rollout {secs:.1f} s")
    return {"frame_seconds": frame_s, "launches": launches,
            "gelu_launches": gelu_launches,
            "frames_per_sec": timing["frames_per_sec"],
            "max_memory_allocated": peak, "setup_s": setup_s,
            "seconds": secs}


# ---------------------------------------------------------------------------
# (z) data parallelism and the profiler
# ---------------------------------------------------------------------------
# phase c's flags, greedy, at UMGen_Large width; the TAR and OAR stacks cut
# to DEFAULT_RUN_LAYERS (the map / box / ego stacks as they are)
DP_FLAGS = ["--infer_task", "video", "--model_scale", "larger", "--fused_oar",
            "--kv_dtype", "bfloat16", "--int8", "decode", "--sample_method",
            "greedy", "--debug", "--save_video", "false"]
DP_FRAMES = 2          # the prefill frame and one cached frame




def _dp_argv(out_dir, dev, scenes, batch, dp):
    return DP_FLAGS + ["--synthetic_data", str(scenes), "--max_scenes",
                       str(scenes), "--batch_size", str(batch), "--dp",
                       str(dp), "--set_num_new_frames", str(DP_FRAMES),
                       "--output_path", out_dir, "--device", str(dev)]


def _gloo_on_cuda(mesh):
    """Which of gloo's collectives take CUDA tensors themselves (the mesh
    reaches gloo through host copies either way): a record, not a check."""
    import torch
    import torch.distributed as dist
    t = torch.ones(4, device=mesh.device)
    ops = {"all_reduce": lambda: dist.all_reduce(t),
           "broadcast": lambda: dist.broadcast(t, 0),
           "all_gather": lambda: dist.all_gather(
               [torch.empty_like(t) for _ in range(mesh.dp)], t)}
    takes = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            takes[name] = True
        except RuntimeError as e:      # recorded: not on the path
            takes[name] = str(e).splitlines()[0][:120]
    return takes


def _dp_rank(mesh, argv, out_dir, layers, train_dir):
    """Entry of phase z's rank processes.  (z1 / z2) `evaluate.rank_main`
    — the rank the CLI's `--dp` starts — on `argv`, the stacks cut to
    `layers`, every launch count reset just before; (z4, where `train_dir`
    is given) one data-parallel AdamW step of the tiny float32 trainer on a
    global batch of 2 and one Adam step of the map VQ codec (MAP_VQ, global
    B = 2).  Writes rank<r>.json (and train_rank<r>.pt) under out_dir."""
    import torch
    from umgen_tpu_torch.ops import decode_kernel as dk
    from umgen_tpu_torch.ops import flash_attention as fa
    from umgen_tpu_torch.tools import evaluate
    args = evaluate.build_parser().parse_args(argv)
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    with _depth(layers):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner, gen = evaluate.rank_main(mesh, args)
        torch.cuda.synchronize()
    res.update(seconds=time.perf_counter() - t0,
               frame_seconds=list(gen.frame_seconds),
               launches={**fa.LAUNCHES, **dk.LAUNCHES},
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if mesh.rank == 0:
        res["collision"] = list(runner.box_overlap.average())
        res["mmd"] = runner.mmd.average()
    if train_dir is not None:
        res["gloo_takes_cuda"] = _gloo_on_cuda(mesh)
        res["train"] = _dp_train(mesh, train_dir)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)


def _tiny_train_job(dev, mesh=None):
    """The tiny float32 trainer (on `mesh` under tp), its seeded params and
    a global batch of 2 (phase y's arguments: the first step is the
    warmup's, lr 0)."""
    import torch
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.layout import SequenceLayout
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    from umgen_tpu_torch.params import init_params
    cfg = ModelConfig(use_pallas_attention=False, dtype="float32").scaled(
        "tiny")
    trainer = UMGenTrainer(UMGen(cfg), learning_rate=3e-4, warmup_steps=1,
                           total_steps=10, mesh=mesh)
    raw = make_token_batch(SequenceLayout(cfg.task), T=3, B=2, seed=1,
                           config=cfg)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in raw.items()}
    return trainer, init_params(cfg, torch.Generator(dev).manual_seed(1),
                                dev), batch


def _dp_train(mesh, train_dir):
    import numpy as np
    import torch
    from umgen_tpu_torch.models import vq
    from umgen_tpu_torch.parallel import optim
    from umgen_tpu_torch.tools.train_vq import VQTrainer, synthetic_rasters
    dev = mesh.device
    trainer, params, batch = _tiny_train_job(dev)
    t0 = time.perf_counter()
    with vq.float32_products():
        state, metrics = trainer.jit_train_step(mesh)(
            trainer.init_state(params), batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    codec = VQTrainer(vq.MAP_VQ, vq.init_normvq(
        torch.Generator(dev).manual_seed(4), vq.MAP_VQ, dev), 1e-4,
        mesh=mesh)
    x = torch.as_tensor(synthetic_rasters(np.random.default_rng(0), 2,
                                          vq.MAP_VQ.resolution,
                                          vq.MAP_VQ.in_channels), device=dev)
    t0 = time.perf_counter()
    m = codec.step(x)
    torch.cuda.synchronize()
    vq_s = time.perf_counter() - t0
    torch.save({"metrics": {k: v.cpu() for k, v in metrics.items()},
                "params": optim.tree_map(lambda t: t.detach().cpu(),
                                         state.params),
                "opt_state": optim.tree_map(lambda t: t.cpu(),
                                            state.opt_state),
                "codec": optim.tree_map(lambda t: t.cpu(),
                                        codec.inference_params()),
                "codec_opt": optim.tree_map(lambda t: t.cpu(),
                                            codec.opt_state)},
               os.path.join(train_dir, f"train_rank{mesh.rank}.pt"))
    return {"step_s": step_s, "vq_step_s": vq_s,
            "vq": {k: float(v) for k, v in m.items()}}


def _same_tokens(got, want, what, ref="the one-process B = 1 run's",
                 phase="z"):
    import numpy as np
    for m in VOCAB:
        if not np.array_equal(got[m], want[m]):
            n = int((np.asarray(got[m]) != np.asarray(want[m])).sum())
            raise AssertionError(f"({phase}) {what}: {m} tokens differ in "
                                 f"{n} places from {ref}")


def phase_dp(dev, work_dir):
    """(z) Data parallelism on the card (two ranks share the one card over
    gloo, the backend a device list naming one card twice gets; one rank
    over NCCL) and `--profile_dir`.  (z1) `--dp 2` through the ranks the CLI
    starts (`parallel.mesh.launch` → `evaluate.rank_main`): phase c's flags,
    greedy, UMGen_Large width, the TAR / OAR stacks at DEFAULT_RUN_LAYERS,
    B = 2 synthetic scenes, one a rank, the prefill frame and a cached one;
    flash, v5 and v5mq must launch in each rank and no other decode kernel;
    tokens in range; each scene's tokens equal bit for bit to a one-process
    B = 1 run of it on the same seeded weights; the collision rate and MMD
    finite.  (z2) the same path at world size 1 over NCCL on scene 0: its
    tokens equal the one-process run's.  (z3) `--profile_dir` on a
    debug-scale CLI run (full width, one layer a stack, the prefill frame):
    the trace file exists and names the flash and decode-step kernels.
    (z4) in z1's ranks after the rollout: one AdamW step of the tiny float32
    trainer on a global batch of 2 (params and moments equal across the
    ranks bit for bit, within TRAIN_* of the one-process step on the whole
    batch here) and one Adam step of the map VQ codec at MAP_VQ, global
    B = 2 (codebooks and params equal across the ranks).  This function
    runs the reference, z1 and z4, whose frame times are read on a quiet
    host; phase_dp_tail runs z2 and z3."""
    import torch
    from umgen_tpu_torch.parallel import mesh as mesh_lib
    from umgen_tpu_torch.tools import evaluate
    res = {"layers": DEFAULT_RUN_LAYERS}
    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "dp")
    dirs = {k: os.path.join(root, k) for k in ("one", "z1", "z2", "z3",
                                               "train")}
    for d in dirs.values():
        os.makedirs(d)
    # the one-process reference: each scene alone, B = 1
    args = evaluate.build_parser().parse_args(
        _dp_argv(dirs["one"], dev, 2, 1, 1))
    with _depth(DEFAULT_RUN_LAYERS):
        _reset_launches()
        t0 = time.perf_counter()
        _, gen = evaluate.run(args)
        res["one_process"] = {"seconds": time.perf_counter() - t0,
                              "frame_seconds": list(gen.frame_seconds),
                              "launches": _launches(("v5", "v5mq"))}
    del gen
    torch.cuda.empty_cache()
    one = _load_tokens(dirs["one"])

    # (z1, z4) two ranks on the card over gloo
    t0 = time.perf_counter()
    mesh_lib.launch(_dp_rank, 2, [dev, dev],
                    _dp_argv(dirs["z1"], dev, 2, 2, 2), dirs["z1"],
                    DEFAULT_RUN_LAYERS, dirs["train"])
    res["z1_wall_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(dirs["z1"], f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"(z1) two ranks on one card ran on "
                                 f"{r['backend']}")
        _rank_launches(r["launches"], ("v5", "v5mq"), f"(z1) rank "
                       f"{r['rank']}")
    _check_tokens(dirs["z1"], scenes=2, frames=20 + DP_FRAMES)
    dp_toks = _load_tokens(dirs["z1"])
    for i, (got, want) in enumerate(zip(dp_toks, one)):
        _same_tokens(got, want, f"z1 scene {i} (rank {i})")
    r0 = ranks[0]
    if not (all(math.isfinite(v) for v in r0["collision"])
            and all(math.isfinite(v) for v in r0["mmd"].values())):
        raise AssertionError(f"(z1) metrics {r0['collision']} {r0['mmd']}")
    res["z1"] = ranks
    print(f"(z1) --dp 2, two ranks sharing the card over gloo, UMGen_Large "
          f"width, {DEFAULT_RUN_LAYERS} TAR / OAR layers, B = 1 a rank: "
          f"per-frame seconds rank 0 "
          f"{', '.join(f'{s:.2f}' for s in ranks[0]['frame_seconds'])}, "
          f"rank 1 {', '.join(f'{s:.2f}' for s in ranks[1]['frame_seconds'])}"
          f" (the one-process B = 1 run: "
          f"{', '.join(f'{s:.2f}' for s in res['one_process']['frame_seconds'])}"
          f"); launches rank 0 {ranks[0]['launches']}, rank 1 "
          f"{ranks[1]['launches']}; both scenes' tokens equal to the "
          f"one-process run's; collision rate {r0['collision']}, MMD "
          f"{r0['mmd']}; {res['z1_wall_s']:.1f} s with the ranks' start "
          f"(gloo takes CUDA tensors: {ranks[0]['gloo_takes_cuda']})")

    # (z4) the ranks' training steps against each other and one process
    res["z4"] = _dp_train_check(dev, dirs["train"], ranks)

    res["seconds"] = time.perf_counter() - t_phase
    print(f"(z: the reference, z1, z4) {res['seconds']:.1f} s")
    return res


def phase_dp_tail(dev, work_dir):
    """(z2, z3) of phase z (phase_dp's docstring), run after the serving
    paths while the CPU sides of the card-against-CPU phases finish: their
    checks read no host clock."""
    import glob

    from umgen_tpu_torch.parallel import mesh as mesh_lib
    from umgen_tpu_torch.tools import evaluate
    res = {}
    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "dp")
    dirs = {k: os.path.join(root, k) for k in ("one", "z2", "z3")}
    one = _load_tokens(dirs["one"])
    # (z2) world size 1 over NCCL
    t0 = time.perf_counter()
    mesh_lib.launch(_dp_rank, 1, [dev], _dp_argv(dirs["z2"], dev, 1, 1, 1),
                    dirs["z2"], DEFAULT_RUN_LAYERS, None)
    res["z2_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(dirs["z2"], "rank0.json")) as f:
        z2 = json.load(f)
    if z2["backend"] != "nccl":
        raise AssertionError(f"(z2) world size 1 ran on {z2['backend']}")
    _rank_launches(z2["launches"], ("v5", "v5mq"), "(z2)")
    [got] = _load_tokens(dirs["z2"])
    _same_tokens(got, one[0], "z2 scene 0")
    res["z2"] = z2
    print(f"(z2) world size 1 over NCCL: per-frame seconds "
          f"{', '.join(f'{s:.2f}' for s in z2['frame_seconds'])}; tokens "
          f"equal to the one-process run's; {res['z2_wall_s']:.1f} s")

    # (z3) --profile_dir
    prof_dir = os.path.join(root, "trace")
    args = evaluate.build_parser().parse_args(
        [a if a != "larger" else "debug" for a in DP_FLAGS]
        + ["--synthetic_data", "1", "--max_scenes", "1",
           "--set_num_new_frames", "1", "--output_path", dirs["z3"],
           "--device", str(dev), "--profile_dir", prof_dir])
    _reset_launches()
    t0 = time.perf_counter()
    evaluate.run(args)
    res["z3_seconds"] = time.perf_counter() - t0
    res["z3_launches"] = _launches(("v5", "v5mq"))
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"(z3) --profile_dir wrote {traces}")
    with open(traces[0]) as f:
        text = f.read()
    # kineto names a kernel event by its demangled signature
    kernels = {k: text.count(k) for k in (
        "flash_attn_wgmma_kernel", "i8_blockmax_kernel", "i8_mix_kernel",
        "i8_finish_kernel", "gemv_i8_staged_kernel", "umgen.rollout",
        '"cat": "kernel"')}
    res["z3_trace"] = {"bytes": len(text.encode()), "events": kernels}
    del text
    os.remove(traces[0])
    print(f"(z3) --profile_dir on a debug-scale CLI run (full width, one "
          f"layer a stack, the prefill frame): {res['z3_seconds']:.1f} s; "
          f"trace {os.path.basename(traces[0])}, "
          f"{res['z3_trace']['bytes'] / 2**20:.1f} MiB, kernel events "
          f"{kernels}")
    if not all(kernels.values()):
        raise AssertionError(f"(z3) the trace misses a kernel: {kernels}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"(z2, z3) {res['seconds']:.1f} s")
    return res


def _rank_launches(launches, decode, what):
    """Flash and the decode kernels `decode` launched in this rank, no
    other (`_launches` on a rank's counts)."""
    must = ["flash_attention"] + [_kernel_name(k) for k in decode]
    for k, n in launches.items():
        if (k in must) != (n > 0):
            raise AssertionError(f"{what}: {k} launched {n} times")


def _dp_train_check(dev, train_dir, ranks):
    import torch
    from umgen_tpu_torch.models import vq
    from umgen_tpu_torch.parallel import optim
    a, b = (torch.load(os.path.join(train_dir, f"train_rank{r}.pt"),
                       weights_only=False) for r in range(2))
    for k in ("params", "opt_state", "codec", "codec_opt"):
        for x, y in zip(optim.tree_leaves(a[k]), optim.tree_leaves(b[k])):
            if not torch.equal(x, y):
                raise AssertionError(f"(z4) the ranks' {k} differ")
    trainer, params, batch = _tiny_train_job(dev)
    with vq.float32_products():
        state, metrics = trainer.train_step(trainer.init_state(params),
                                            batch)
    one = {"metrics": {k: v.cpu() for k, v in metrics.items()},
           "params": optim.tree_map(lambda t: t.detach().cpu(),
                                    state.params),
           "opt_state": optim.tree_map(lambda t: t.cpu(), state.opt_state)}
    errs = {"metrics_rel_err": max(
        abs(float(a["metrics"][k]) - float(v)) / abs(float(v))
        for k, v in one["metrics"].items())}
    worst, errs["zero_leaves"], errs["roundoff_leaves"] = _grad_errors(
        one["opt_state"], a["opt_state"])
    errs["grad_rel_l2_max"] = worst
    errs["params_max_abs_err"] = max(
        float((y - x).abs().max()) for x, y in zip(
            optim.tree_leaves(one["params"]),
            optim.tree_leaves(a["params"])))
    out = {**errs, "rank_steps": [r["train"] for r in ranks]}
    print(f"(z4) two ranks on the card: the tiny float32 AdamW step's params "
          f"and moments, the map VQ codec's (MAP_VQ, global B = 2) codebook, "
          f"params and Adam state equal across the ranks bit for bit; "
          f"against the one-process step on the whole batch: loss terms rel "
          f"err {errs['metrics_rel_err']:.3g} (bound {TRAIN_LOSS_RTOL:g}), "
          f"gradients (mu / 0.1) rel L2 {worst:.3g} (bound "
          f"{TRAIN_GRAD_RTOL:g}; {errs['zero_leaves']} zero and "
          f"{errs['roundoff_leaves']} roundoff leaves), params "
          f"{errs['params_max_abs_err']:.3g} "
          f"(bound {TRAIN_PARAM_ATOL:g}); rank steps "
          f"{[round(r['train']['step_s'], 3) for r in ranks]} s, VQ "
          f"{[round(r['train']['vq_step_s'], 3) for r in ranks]} s")
    if (errs["metrics_rel_err"] > TRAIN_LOSS_RTOL
            or worst > TRAIN_GRAD_RTOL
            or errs["params_max_abs_err"] > TRAIN_PARAM_ATOL):
        raise AssertionError(f"(z4) the data-parallel step disagrees with "
                             f"the one-process step: {errs}")
    return out


# ---------------------------------------------------------------------------
# (tp) tensor parallelism
# ---------------------------------------------------------------------------
# phase c's flags, greedy, at UMGen_Large width (16 heads, 8 a rank); every
# stack cut to TP_LAYERS, a TP_WINDOW-frame window and rings, one scene
TP_LAYERS = 2
TP_WINDOW = 4
TP_FRAMES = 2          # the prefill frame and one cached frame
# a run of tokens that differs from the one-process run must start at a
# decision whose top-2 gap is within this many bf16 ulps: the all-reduce
# adds the float32 partial sums in another order
TP_GAP_ULPS = 16
# the bf16 training step at tp = 2 against one process (stated before the
# first run): bf16 activations whose sums run in another order
TP_BF16_LOSS_RTOL = 2.0 ** -6
TP_BF16_GRAD_RTOL = 5e-2
TP_STACKS = ("n_tar_layer", "n_oar_layer", "n_ego_tar_layer",
             "n_map_tar_layer", "n_box_tar_layer", "n_ego_ca_layer")


def _tp_model(dev):
    """(model, whole params, conditioning window): the CLI's config and
    seeded weights (evaluate.build_params: int8 decode weights and their
    packs) for phase c's flags, every stack at TP_LAYERS."""
    from umgen_tpu_torch.data.pipeline import ScenePipeline
    from umgen_tpu_torch.data.synthetic import make_token_batch
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.tools import evaluate
    args = evaluate.build_parser().parse_args(
        DP_FLAGS + ["--device", str(dev), "--tar_cache_window",
                    str(TP_WINDOW)])
    cfg = evaluate.config_from_args(args).replace(
        **{k: TP_LAYERS for k in TP_STACKS})
    params = evaluate.build_params(args, cfg, dev, ScenePipeline())
    model = UMGen(cfg)
    cond = make_token_batch(model.layout, T=TP_WINDOW, B=1, seed=7,
                            config=cfg)
    return model, params, cond


def _tp_generate(gen, cond, **kw):
    return gen.generate(cond, new_frames=TP_FRAMES, cond_frames=TP_WINDOW,
                        input_cond_frames=TP_WINDOW, **kw)


def _tp_bf16_job(dev, mesh=None):
    """The trainer of the rollout's model (bf16, UMGen_Large width, every
    stack at TP_LAYERS, no remat; on `mesh` under tp), its seeded params
    and a 3-frame batch (the first step is the warmup's, lr 0: the
    gradients are compared)."""
    from umgen_tpu_torch.config import ModelConfig
    from umgen_tpu_torch.models.umgen import UMGen
    from umgen_tpu_torch.parallel.train import UMGenTrainer
    from umgen_tpu_torch.params import init_params
    cfg = ModelConfig(use_pallas_attention=False).scaled("larger").replace(
        **{k: TP_LAYERS for k in TP_STACKS})
    import torch
    trainer = UMGenTrainer(UMGen(cfg), learning_rate=3e-4, warmup_steps=1,
                           total_steps=10, mesh=mesh)
    return trainer, init_params(cfg, torch.Generator(dev).manual_seed(5),
                                dev), _train_batch(trainer.layout, cfg, 3,
                                                   dev, seed=2)


def _host_state(state, metrics):
    from umgen_tpu_torch.parallel import optim
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": optim.tree_map(lambda t: t.detach().cpu(),
                                     state.params),
            "opt_state": optim.tree_map(lambda t: t.cpu(), state.opt_state)}


def _tp_step(mesh, job):
    """One step of `job` (trainer, params, batch) over the mesh from the
    rank's blocks: (whole state on the host, the rank's replicated leaves,
    seconds)."""
    import torch
    from umgen_tpu_torch.parallel.mesh import split_rule, tree_paths
    from umgen_tpu_torch.parallel.train import shard_state, whole_state
    trainer, params, batch = job
    state = shard_state(mesh, trainer.init_state(params))
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = trainer.jit_train_step(mesh)(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    local = {p: t.detach().cpu() for p, t in tree_paths(
        {"params": state.params, "opt": state.opt_state})
        if split_rule(p) is None}
    return _host_state(whole_state(mesh, state), metrics), local, seconds


def _tp_rank(mesh, out_dir):
    """Entry of phase tp's rank processes: (tp1) the rollout on the rank's
    blocks of the seeded weights, every launch count reset just before;
    (tp2) the bf16 step of the same model and the tiny float32 step.
    Writes rank<r>.pt under out_dir."""
    import torch
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.ops import decode_kernel as dk
    from umgen_tpu_torch.ops import flash_attention as fa
    dev = mesh.device
    model, params, cond = _tp_model(dev)
    gen = Generator(model, mesh.shard_params(params), seed=0, device=dev,
                    mesh=mesh)
    del params
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _tp_generate(gen, cond)
    torch.cuda.synchronize()
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "seconds": time.perf_counter() - t0,
           "frame_seconds": list(gen.frame_seconds),
           "launches": {**fa.LAUNCHES, **dk.LAUNCHES},
           "n_head": model.config.n_head, "heads": gen.model.heads,
           "oar_heads": gen.rollout.oar_heads(gen.params),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "tokens": out}
    del gen
    torch.cuda.empty_cache()
    res["bf16"] = _tp_step(mesh, _tp_bf16_job(dev, mesh))
    res["tiny"] = _tp_step(mesh, _tiny_train_job(dev, mesh))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def _tp_divergences(mine, ref, top2, first, frames):
    """`spec_divergences` of the tp run's tokens against a one-process
    run's, from frame `first` on for `frames` frames (`top2` the one-process
    run's decisions there), with the ego action's decision too: per frame
    the share of equal tokens and the runs of differing positions, each
    with its first decision's top-2 gap in bf16 ulps."""
    import numpy as np
    out = spec_divergences(mine, ref, top2, frames, first=first)
    per_frame = FRAME_DECISIONS
    for f in range(frames):
        a = np.asarray(mine["pose"])[0, first + f]
        b = np.asarray(ref["pose"])[0, first + f]
        if (a != b).any():
            t = top2[f * per_frame].reshape(-1, 2)[0].cpu().numpy()
            ulp = 2.0 ** (np.floor(np.log2(max(abs(t[0]), 2.0 ** -3))) - 7)
            run = ("pose", 0, float((t[0] - t[1]) / ulp))
            o = out[f + 1]
            o["runs"] += 1
            if o["worst_run_start"] is None or \
                    run[2] > o["worst_run_start"][2]:
                o["worst_run_start"] = run
    return out


def _step_errors(one, got):
    """A whole state after a step against another: (loss terms' largest
    relative error, gradients' (mu / 0.1) worst relative L2, zero and
    roundoff leaves)."""
    rel = max(abs(got["metrics"][k] - v) / abs(v)
              for k, v in one["metrics"].items())
    worst, zeros, roundoff = _grad_errors(one["opt_state"],
                                          got["opt_state"])
    return rel, worst, zeros, roundoff


def phase_tp(dev, work_dir):
    """(tp) Tensor parallelism on the card: two ranks at tp = 2 share it
    over gloo (NCCL refuses two ranks on one card).  (tp1) the GSPMD-mode
    Generator: phase c's flags, greedy, UMGen_Large width (8 of 16 heads a
    rank), every stack cut to TP_LAYERS, a TP_WINDOW-frame window, B = 1,
    the prefill frame and one cached frame; the TAR family split, flash on
    the rank's heads; the OAR whole on both ranks (v5 and v5mq on the int8
    decode packs, as GSPMD replicates JAX's custom call); flash, v5 and
    v5mq must launch in each rank and no other decode kernel; the ranks'
    tokens equal, and against a one-process run on the same weights equal
    or every run of differing positions starting at a near tie (<=
    TP_GAP_ULPS bf16 ulps): the prefill frame against the free-running
    one-process run, the cached frame against a one-process run whose
    prefill frame is teacher-forced to rank 0's tokens (its window then
    holds the same frames).  (tp2) one bf16 AdamW step of the same model
    (B = 1, 3 frames) at tp = 2 against the one-process step (loss terms
    within TP_BF16_LOSS_RTOL, gradients within TP_BF16_GRAD_RTOL rel L2),
    and the tiny float32 step within TRAIN_*; in both the replicated
    leaves and moments equal across the ranks bit for bit."""
    import numpy as np
    import torch
    from umgen_tpu_torch.models.generate import Generator
    from umgen_tpu_torch.parallel import mesh as mesh_lib
    res = {"layers": TP_LAYERS, "window": TP_WINDOW}
    t_phase = time.perf_counter()
    out_dir = os.path.join(work_dir, "tp")
    os.makedirs(out_dir)
    # the one-process references: the rollout (each decision's top-2
    # logits kept) and the two steps
    model, params, cond = _tp_model(dev)
    gen = Generator(model, params, seed=0, device=dev)
    log = _GreedyLog()
    for m in gen.rollout._samplers:
        gen.rollout._samplers[m] = log
    _reset_launches()
    t0 = time.perf_counter()
    one = _tp_generate(gen, cond)
    torch.cuda.synchronize()
    res["one_process"] = {"seconds": time.perf_counter() - t0,
                          "frame_seconds": list(gen.frame_seconds),
                          "launches": _launches(("v5", "v5mq"))}
    del gen
    steps = {}
    for name, job in (("bf16", _tp_bf16_job), ("tiny", _tiny_train_job)):
        trainer, job_params, batch = job(dev)
        state, metrics = trainer.train_step(trainer.init_state(job_params),
                                            batch)
        steps[name] = _host_state(state, metrics)
        del trainer, job_params, state
    torch.cuda.empty_cache()

    # (tp1, tp2) two ranks sharing the card
    t0 = time.perf_counter()
    mesh_lib.launch(_tp_rank, 1, [dev, dev], out_dir, tp=2)
    res["wall_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"(tp1) two ranks on one card ran on "
                                 f"{r['backend']}")
        if (r["heads"], r["oar_heads"]) != (r["n_head"] // 2, r["n_head"]):
            raise AssertionError(f"(tp1) rank {r['rank']} ran {r['heads']} "
                                 f"TAR heads, {r['oar_heads']} OAR heads")
        _rank_launches(r["launches"], ("v5", "v5mq"),
                       f"(tp1) rank {r['rank']}")
    _same_tokens(ranks[1]["tokens"], ranks[0]["tokens"], "tp1 rank 1",
                 "rank 0's", "tp1")
    mine = ranks[0]["tokens"]
    div = _tp_divergences(mine, one, log.top2, TP_WINDOW, TP_FRAMES)
    # the cached frame reads a window holding each run's first frame: held
    # against a one-process run teacher-forced to rank 0's first frame
    gen = Generator(model, params, seed=0, device=dev)
    flog = _GreedyLog()
    for m in gen.rollout._samplers:
        gen.rollout._samplers[m] = flog
    forced = _tp_generate(gen, cond, forced_streams={
        m: np.asarray(v)[:, TP_WINDOW:TP_WINDOW + 1] for m, v in mine.items()})
    del gen, model, params
    for m, v in mine.items():
        if not np.array_equal(np.asarray(forced[m])[:, :TP_WINDOW + 1],
                              np.asarray(v)[:, :TP_WINDOW + 1]):
            raise AssertionError(f"(tp1) the teacher-forced run's first "
                                 f"frame is not rank 0's ({m})")
    if len(flog.top2) < FRAME_DECISIONS:
        raise AssertionError(f"(tp1) the teacher-forced run's cached frame "
                             f"made {len(flog.top2)} decisions")
    div_free = div[2]
    div[2] = _tp_divergences(mine, forced, flog.top2[-FRAME_DECISIONS:],
                             TP_WINDOW + 1, 1)[1]
    res["divergences"] = {**div, "2_free_running": div_free}
    for f in (1, 2):
        w = div[f]["worst_run_start"]
        if w is not None and w[2] > TP_GAP_ULPS:
            raise AssertionError(f"(tp1) frame {f}: a run of tokens that "
                                 f"differs from the one-process run starts "
                                 f"at a gap of {w[2]:.1f} bf16 ulps: {div}")
    res["ranks"] = [{k: v for k, v in r.items()
                     if k not in ("tokens", "bf16", "tiny")} for r in ranks]
    print(f"(tp1) tp = 2, two ranks sharing the card over gloo, UMGen_Large "
          f"width (8 heads a rank), {TP_LAYERS} layers a stack, a "
          f"{TP_WINDOW}-frame window, B = 1: per-frame seconds rank 0 "
          f"{', '.join(f'{s:.2f}' for s in ranks[0]['frame_seconds'])}, "
          f"rank 1 {', '.join(f'{s:.2f}' for s in ranks[1]['frame_seconds'])}"
          f" (one process: "
          f"{', '.join(f'{s:.2f}' for s in res['one_process']['frame_seconds'])}"
          f"); launches in each rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
          f"; the ranks' tokens equal; against one process (frame 2 against "
          f"its run teacher-forced to rank 0's frame 1): {div}; frame 2 "
          f"against the free-running one: {div_free}; "
          f"{res['wall_s']:.1f} s with the ranks' start")

    # (tp2) the steps
    for name in ("bf16", "tiny"):
        a, b = (r[name] for r in ranks)
        for k in a[1]:
            if not torch.equal(a[1][k], b[1][k]):
                raise AssertionError(f"(tp2) {name}: the ranks' replicated "
                                     f"leaf {k} differs")
        rel, worst, zeros, roundoff = _step_errors(steps[name], a[0])
        loss_tol, grad_tol = ((TP_BF16_LOSS_RTOL, TP_BF16_GRAD_RTOL)
                              if name == "bf16" else
                              (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL))
        res[f"train_{name}"] = {
            "metrics_rel_err": rel, "grad_rel_l2_max": worst,
            "zero_leaves": zeros, "roundoff_leaves": roundoff,
            "rank_step_s": [r[name][2] for r in ranks],
            "replicated_leaves": len(a[1])}
        print(f"(tp2) {name} AdamW step at tp = 2 against one process: loss "
              f"terms rel err {rel:.3g} (bound {loss_tol:g}), gradients rel "
              f"L2 {worst:.3g} (bound {grad_tol:g}; {zeros} zero and "
              f"{roundoff} roundoff leaves); {len(a[1])} replicated leaves "
              f"equal across the ranks; rank steps "
              f"{[round(r[name][2], 3) for r in ranks]} s")
        if rel > loss_tol or worst > grad_tol:
            raise AssertionError(f"(tp2) {name}: the tp step disagrees with "
                                 f"the one-process step: {res[f'train_{name}']}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"(tp) {res['seconds']:.1f} s")
    return res


def _load_tokens(out_dir):
    import pickle
    tok_dir = os.path.join(out_dir, "saved_token")
    outs = []
    for name in sorted(os.listdir(tok_dir)):
        with open(os.path.join(tok_dir, name), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _check_stands_alone():
    """The port imports neither jax nor the JAX package (nor optax or
    orbax)."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "umgen_tpu",
                                            "optax", "orbax"))
    if foreign:
        raise AssertionError(f"the port imported {foreign[:5]}")


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", nargs="+", default=None, metavar="KEY",
                    help="run only these phases, by the key of their report "
                    "(flash gelu decode variants step_loops rollout reference "
                    "serving serving_reference serving_i4 rollout_i4 "
                    "serving_i4_reference rollout_bf16kv rollout_v7 "
                    "rollout_fp8kv rollout_v1 bf16kv_reference "
                    "rollout_default rollout_recompute rollout_refresh "
                    "recompute_reference default_reference control "
                    "control_reference_control_cached "
                    "control_reference_control_recompute "
                    "control_reference_init_token_mod speculative "
                    "tar_options options_reference_spec_serving "
                    "options_reference_spec_i4 options_reference_w4_int2 "
                    "options_reference_relative_cached "
                    "options_reference_relative_recompute vq train dp tp; "
                    "refresh "
                    "needs recompute; vq and train run their card-vs-CPU "
                    "checks too), "
                    "for work on one of them; prints no result line")
    only = ap.parse_args(argv).phases
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import umgen_tpu_torch  # noqa: F401  (sets the TF32 switches)
    _check_stands_alone()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t_start = time.perf_counter()
    try:
        return _run_phases(dev, smi, report, t_start,
                           None if only is None else set(only))
    finally:     # whatever was measured before a failure is kept
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
                  "w") as f:
            json.dump(report, f, indent=1)


def _run_phases(dev, smi, report, t_start, only=None) -> int:
    """Every phase; `only`: the report keys of the phases to run (a partial
    run prints no result line)."""
    pending = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as work_dir:
        try:
            return _phases(dev, smi, report, t_start, only, pending,
                           work_dir)
        finally:        # no child outlives the run
            for check in pending.values():
                check.stop()


def _phases(dev, smi, report, t_start, only, pending, work_dir) -> int:
    import torch

    def want(key):
        return only is None or key in only

    report["build"] = phase_build()
    if want("flash"):
        (report["flash"], flash_err, report["flash_planted"],
         report["flash_profile"]) = phase_flash(dev)
    if want("gelu"):
        report["gelu"] = phase_gelu(dev)
        torch.cuda.empty_cache()
    cfg, packs, visible = _decode_params(dev)
    report["decode"] = {}
    if want("decode"):
        rows, profiles = phase_decode(dev, cfg, packs, visible)
        report["decode"].update(rows)
        report["w4_profile"] = profiles["w4"]
        report["w4i4_profile"] = profiles["w4i4"]
        report["v5_profile"] = profiles["v5"]
    if want("variants"):
        rows, profiles = phase_variants(dev, cfg, packs, visible)
        report["decode"].update(rows)
        report["v2_profile"] = profiles["v2"]
        report["v1_profile"] = profiles["v1"]
    report["attention_alone"] = attention_summary(report["decode"])
    torch.cuda.empty_cache()
    if want("step_loops"):
        report["step_loops"] = phase_step_loops(dev, cfg, packs)
    del packs, visible
    torch.cuda.empty_cache()

    def rollout(key, **kw):
        if want(key):
            with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
                report[key] = phase_rollout(dev, out_dir, **kw)
            torch.cuda.empty_cache()

    def serving(key, **kw):
        if want(key):
            with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
                report[key] = phase_serving(dev, out_dir, **kw)
            torch.cuda.empty_cache()

    # first the paths at B = 1 and 2, whose frame times the host's launch
    # rate bounds: nothing else runs on the host meanwhile
    rollout("rollout")
    rollout("rollout_i4", tag="h", new_frames=1,
            flags=("--oar_kv_dtype", "int4"), must=("v5i4", "v5mqi4"))
    rollout("rollout_bf16kv", tag="j", scale="stander", new_frames=1,
            flags=("--oar_kv_dtype", "bfloat16"), must=("v2",))
    rollout("rollout_v7", tag="k", flags=("--oar_kernel", "7"), B=2,
            new_frames=1,
            scale="stander", must=("v7", "v5mq"))
    rollout("rollout_fp8kv", tag="l", new_frames=1, scale="stander",
            flags=("--oar_kv_dtype", "float8_e4m3fn"), must=("v2",))
    if want("rollout_v1"):
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            report["rollout_v1"] = phase_slice_v1(dev, out_dir)
        torch.cuda.empty_cache()
    # data parallelism (z: the reference, z1, z4): ranks that share the card
    # and the host, before the CPU sides below start
    if want("dp"):
        report["dp"] = phase_dp(dev, work_dir)
        torch.cuda.empty_cache()
    # speculative decoding (u), W4 TAR weights on int2 rings (v)
    if want("speculative"):
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir, \
                tempfile.TemporaryDirectory(dir=ROOT) as seq_dir:
            report["speculative"] = phase_speculative(dev, out_dir, seq_dir)
        torch.cuda.empty_cache()
    if want("tar_options"):
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            report["tar_options"] = phase_tar_options(dev, out_dir)
        torch.cuda.empty_cache()
    # the reference's own window semantics (o, p, q)
    if want("rollout_default"):
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            report["rollout_default"] = phase_default_run(dev, out_dir)
        torch.cuda.empty_cache()
    recompute_tokens = None
    if want("rollout_recompute"):
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            report["rollout_recompute"] = phase_recompute(dev, out_dir)
        recompute_tokens = report["rollout_recompute"].pop("tokens")
        torch.cuda.empty_cache()
    if want("rollout_refresh") and recompute_tokens is not None:
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            report["rollout_refresh"] = phase_refresh(dev, out_dir,
                                                      recompute_tokens)
        torch.cuda.empty_cache()
    # the control task on an imported checkpoint (s)
    if want("control"):
        with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
            report["control"] = phase_control(dev, out_dir, work_dir)
        torch.cuda.empty_cache()
    # the VQ detokenizers (x): the card's side now, the CPU's in a child
    # process beside the checks below
    if want("vq"):
        report["vq"], pending["vq_reference"] = phase_vq(dev, work_dir)
        torch.cuda.empty_cache()
    # then the card-against-CPU checks (d, n, f, i): the card's side of each
    # runs now, its CPU side in a child process while the card runs the two
    # serving paths, which the device bounds
    for key, fn, kw in (
            ("reference", phase_reference, {}),
            ("bf16kv_reference", phase_reference,
             {"tag": "n", "oar_cache_dtype": "bfloat16"}),
            ("serving_reference", phase_serving_reference, {}),
            ("serving_i4_reference", phase_serving_reference,
             {"tag": "i", "oar_cache_dtype": "int4", "B": 1}),
            ("recompute_reference", phase_reference,
             {"tag": "r-recompute", "step": "recompute",
              "tar_mode": "recompute"}),
            ("default_reference", phase_reference,
             {"tag": "r-default", "tar_cache_dtype": "float8_e4m3fn",
              "oar_cache_dtype": "float8_e4m3fn",
              "fused_oar_kernel": False})):
        if want(key):
            pending[key] = fn(dev, work_dir, **kw)
            torch.cuda.empty_cache()
    for tag in CONTROL_CASES:                       # (t)
        key = "control_reference_" + tag[2:].replace("-", "_")
        if want(key):
            pending[key] = phase_control_reference(dev, work_dir, tag)
            torch.cuda.empty_cache()
    for tag in OPTION_CASES:                        # (w)
        key = "options_reference_" + tag[2:].replace("-", "_")
        if want(key):
            pending[key] = phase_options_reference(dev, work_dir, tag)
            torch.cuda.empty_cache()
    # training (y), device-bound like the serving paths, while the CPU
    # sides above run; its own tiny step's CPU side in a child too
    if want("train"):
        report["train"], pending["train_reference"] = phase_train(dev,
                                                                  work_dir)
        torch.cuda.empty_cache()
    serving("serving")
    serving("serving_i4", tag="g", oar_int4=True)
    if want("dp"):            # (z2, z3) while the CPU sides finish
        report["dp"].update(phase_dp_tail(dev, work_dir))
        torch.cuda.empty_cache()
    if want("tp"):            # (tp) too
        report["tp"] = phase_tp(dev, work_dir)
        torch.cuda.empty_cache()
    t_wait = time.perf_counter()
    for key in list(pending):
        report[key] = pending.pop(key).finish()
    print(f"waited {time.perf_counter() - t_wait:.1f} s for the CPU sides")
    _check_stands_alone()
    report["seconds"] = time.perf_counter() - t_start
    print(f"all phases {report['seconds']:.1f} s")
    if only is not None:
        print(f"ran only {sorted(only)}: no result line")
        return 0

    def pick(rows, **kw):
        return next(r for r in rows if all(r[k] == v for k, v in kw.items()))

    def entry(kind, line, launches, **at):
        """One decode kernel's line: its times and bound at the main
        path's shape `at`, its launches on the path that runs it."""
        name = _kernel_name(kind)
        r = pick(dec[kind], **at)
        return {"name": name, "route": "cuda",
                "source": "umgen_tpu_torch/csrc/decode_step.cu",
                "replaces": f"umgen_tpu/ops/decode_kernel.py:{line}",
                "launches": launches[name],
                "redesigned_in": REDESIGNED.get(kind),
                "max_abs_err": max(x["max_abs_err"] for x in dec[kind]),
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}

    dec = report["decode"]
    slice1 = report["rollout"]["launches"]        # the bf16-ring slice (c)
    spec = report["speculative"]["launches"]      # speculation, K = 8 (u)
    serve = report["serving"]["launches"]         # the serving path (e)
    serve4 = report["serving_i4"]["launches"]     # serving-i4 (g)
    slice4 = report["rollout_i4"]["launches"]     # slice-i4 (h)
    bf16kv = report["rollout_bf16kv"]["launches"]  # slice-bf16kv (j)
    slice7 = report["rollout_v7"]["launches"]     # slice-v7 (k)
    slice_v1 = report["rollout_v1"]["launches"]   # slice-v1 (l)
    loops = report["step_loops"]["launches"]      # the step loops (m)
    # serving-i4 calls flash once a TAR block on its 10 scenes' frame
    f1 = pick(report["flash"], B=10, Sq=2207, causal=False)
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "umgen_tpu_torch/csrc/flash_attention.cu",
         "replaces": "umgen_tpu/ops/flash_attention.py:79",
         "launches": serve4["flash_attention"], "max_abs_err": flash_err,
         "redesigned_in": REDESIGNED["flash_attention"],
         **{k: f1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}},
        entry("v5", 1363, slice1, B=1, cache_len=1100),
        entry("v5mq", 3411, spec, B=1, Q=8, cache_len=1100),
        entry("w4", 2034, serve, B=10, cache_len=1100),
        entry("w4mq", 3488, serve, B=10, Q=6, cache_len=0),
        entry("v5i4", 2588, slice4, B=1, cache_len=1100),
        entry("v5mqi4", 3451, slice4, B=1, Q=6, cache_len=0),
        entry("w4i4", 2883, serve4, B=10, cache_len=1100),
        entry("w4mqi4", 3523, serve4, B=10, Q=6, cache_len=0),
        entry("v1", 186, slice_v1, kv="bfloat16", cache_len=1100),
        entry("v2", 497, bf16kv, kv="bfloat16", cache_len=1100),
        entry("v3", 752, loops, cache_len=1100),
        entry("v4", 1052, loops, cache_len=1100),
        entry("v6", 1654, loops, cache_len=1100),
        entry("v7", 2293, slice7, B=2, cache_len=1100),
    ]
    # the exact-erf GELU: an XLA fusion in the JAX package, no pallas_call;
    # launches over phase e's rollout (19 ingested frames and one generated)
    g1 = report["gelu"]["rows"][0]
    kernels.append({
        "name": "gelu", "route": "cuda",
        "source": "umgen_tpu_torch/csrc/gelu.cu",
        "replaces": "XLA's fusion of jax.nn.gelu (no pallas_call)",
        "launches": report["serving"]["gelu_launches"],
        "redesigned_in": None, "max_abs_err": report["gelu"]["max_abs_err"],
        **{k: g1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}})
    report["kernels"] = kernels
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
