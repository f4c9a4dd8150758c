// Fused OAR decode step: Q new rows per scene through all L layers, with
// int8 (W8A8) or group-int4 (W4A8) weights.
//
// Replaces the TPU kernels of umgen_tpu/ops/decode_kernel.py:
//   * `fused_decode_step_v5` (Q = 1) and `fused_decode_step_v5mq` /
//     `_mq_call` (1 < Q <= 128/H): int8 weights, entry `umgen_decode_step`;
//   * `fused_decode_step_w4` (Q = 1, `_kernel_w4`) and
//     `fused_decode_step_w4mq` (`_mq_call` with w4=True): W4A8 weights,
//     entry `umgen_decode_step_w4`;
//   * `fused_decode_step_v5i4` / `fused_decode_step_v5mqi4` and
//     `fused_decode_step_w4i4` / `fused_decode_step_w4mqi4` (`_kernel_v5i4`,
//     `_kernel_w4i4`, `_mq_call` with int4=True): the same steps on the
//     nibble-packed int4 KV cache, entries `umgen_decode_step_i4` and
//     `umgen_decode_step_w4_i4`;
//   * `fused_decode_step_v3` and `_v4` (`_kernel_v3`, `_kernel_v4`): the v5
//     arithmetic on a 5-D int8 cache [L, B, S, H, Dh], whose memory is the
//     flat cache's — `umgen_decode_step` on the view; v4's six weight streams
//     are a TPU DMA schedule, the kernel reads the one output-major layout;
//   * `fused_decode_step_v6` (`_kernel_v6`): v5 with the new rows put on the
//     int8 grid from float32 (flag STEP_ROWS_F32) — its in-place append is
//     what every entry here does;
//   * `fused_decode_step_v7` (`_kernel_v7`): v5 with one query scale per
//     (scene, head) (flag STEP_HEAD_SCALE), any B;
//   * `fused_decode_step_v2` (`_kernel_v2`) and `fused_decode_step` (v1,
//     `_kernel`): int8 weights on a bf16 / fp8 (e4m3) / int8-grid cache read
//     as bf16, entry `umgen_decode_step_dense` (see "Prefix attention"
//     below).
// Per layer: LN1 → QKV → attention over the int8 KV prefix plus the chunk's
// own rows (causal within the chunk) → proj + residual → LN2 → fc → GELU
// (Abramowitz & Stegun erf) → proj + residual.  Activations are quantized
// per row (absmax/127) to int8.  W8A8: weights int8 per output channel,
// y = acc·sa·ws (+ b).  W4A8: weights symmetric int4 in [-7, 7] with one
// scale per (128-row input group, output column); the two groups of a pair
// (2j, 2j+1) share a byte (low / high nibble).  The GEMV gives a thread a
// pair of a column: it unpacks the pair's 128 bytes once into the two
// groups' sign-extended int8 values and takes __dp4a against the rows'
// activations, staged in shared memory, into the two groups' int32 sums;
// the group scales are applied in float32 in the reference's order: y = y +
// acc_lo·s_lo + acc_hi·s_hi over the pairs, then y·sa (+ b).  The integer part is exact, and built with
// --fmad=false the epilogues round where the plain versions do.  The
// residual stream rounds to bf16 after every add.  The chunk's K/V rows are
// written into the caches at `cache_len` on the fixed 1/16 int8 grid — in
// place (the JAX package writes the cache back functionally).
//
// The int4 cache stores a row's H·Dh values as H·Dh/2 bytes in the halves
// layout — byte j holds value j in its low nibble and value j + H·Dh/2 in its
// high nibble, so heads hh and hh + H/2 share the bytes [hh·Dh, (hh+1)·Dh) —
// with one float32 scale s = max|x| + 1e-12 per (row, head): q = clip(round(
// x·(7/s)), ±7).  The prefix attention never dequantizes: a (row, head)
// thread sign-extends its head's nibbles into int8 lanes, takes __dp4a
// against the int8 queries, and folds the scales into the logit, logit =
// (li·ks[row, head])·(sq·scale/7), and into the softmax weight, pv =
// bf16(p·vs[row, head]·(1/7)), which multiplies the value nibbles as they
// are — on the same S-block passes as the int8 cache (i8_blockmax_kernel).
// New rows are quantized from their bf16 rounding by the step's prep pass:
// one warp owns a pair of heads that share bytes, a lane a byte, so every
// byte has one writer.  The int4 rows halve the KV stream (2 x 384 B of
// nibbles + 2 x 64 B of scales per cached row per layer per scene at
// d = 768, H = 16, against 2 x 768 B).
//
// What bounds it on the H100: a step reads every layer's weights — int8
// 7.1 MB a layer at d = 768 (255 MB for 36 layers); W4A8 (768·3072 +
// 768·3072 + 3072·768) / 2 bytes = 3.5 MB plus 0.2 MB of group scales a
// layer (about 135 MB for 36) — and the KV prefix (2 x 768 B per cached row
// per layer per scene, up to 122 MB per scene at a full 2208-row cache);
// the arithmetic is a few ops/byte, so the stream floor is 0.05-0.12 ms at
// 3.35 TB/s.  The TPU kernel ran the 36 layers as one sequential grid with
// the hidden state carried in VMEM.  Hopper blocks carry nothing from one
// grid step to the next, so this version issues the layer sequence from
// the host (one C call per step, seven to ten small kernels per layer on
// one stream): the hidden state lives in a global workspace between kernels.
// The prefix attention on every cache keeps the reference's S-blocks
// (`_kernel_w4`'s, `_kernel_v5i4`'s and `_kernel_v2`'s rounding points; see
// i8_blockmax_kernel): a sub-block of 32 rows a CUDA block for the logits,
// the maxima, the weights and the value sums, then one thread a lane folds
// them block by block; the dense caches (bf16, fp8, int8 read as bf16) are
// instances of the same passes.  Both GEMVs stage the rows' activations in
// shared memory a tile of rows at a time, so neither bounds B·Q; the int8
// GEMV puts every weight chunk of a lane in flight before anything else and,
// at one or two rows, normalizes and quantizes the rows in its own blocks
// (ln_quant_kernel's launch gone).  Launches a layer with a prefix: seven for
// int8 weights at B·Q <= 2, ten otherwise (the prep pass rides in the
// block-max launch): the host's launch rate is the next limit (graph capture
// or a persistent kernel), then wgmma/TMA weight streams.
// A bf16 cache doubles the KV stream (2 x 1536 B a cached row a layer a scene,
// up to 244 MB a scene at 2208 rows), fp8 equals int8's.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int W4_MAX_PAIRS = 12;  // W4 GEMV input groups / 2 (K <= 3072)
constexpr int ATT_THREADS = 128;  // >= Q * H pairs (Q * H <= 128)
constexpr int MAX_Q = 8;          // rows a scene of one step

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int8_t quant_i8(float x, float s) {
  const float r = rintf(x / s);
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

// block-wide maximum over blockDim.x threads (a multiple of 32, <= 1024)
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = red[0];
  for (int i = 1; i < nw; ++i) s = fmaxf(s, red[i]);
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// n bytes (a multiple of 16, both ends 16-byte aligned) into shared memory:
// every copy in flight at once; cp.async.wait_all and a barrier complete them
__device__ __forceinline__ void stage_async(void* dst, const void* src,
                                            int n) {
  int4* d = reinterpret_cast<int4*>(dst);
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int i = threadIdx.x; i < n / 16; i += blockDim.x) cp_async16(d + i, s + i);
}

// n floats (4-byte aligned) into shared memory, as one commit group: a later
// stage_wait_but_last() completes it while the copies issued after it fly on
__device__ __forceinline__ void stage_async_f32(float* dst, const float* src,
                                                int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst + i)),
                 "l"(src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait_but_last() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// the reference kernel's erf (A&S 7.1.26) and exact-form GELU
__device__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + p * ax);
  const float y =
      1.f - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t *
                expf(-ax * ax);
  return s * y;
}

__device__ float gelu_as(float x) {
  const float sqrt2 = 1.41421353816986083984375f;  // float32(sqrt(2))
  return x * 0.5f * (1.f + erf_as(x / sqrt2));
}

__global__ void init_h_kernel(const __nv_bfloat16* x, float* h, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) h[i] = __bfloat162float(x[i]);
}

__global__ void out_bf16_kernel(const float* h, __nv_bfloat16* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float2bfloat16_rn(h[i]);
}

enum Epilogue { EPI_STORE = 0, EPI_GELU = 1, EPI_RESID = 2 };

__device__ __forceinline__ void store_epi(float* dst, float y, int epi) {
  if (epi == EPI_GELU) {
    *dst = gelu_as(y);
  } else if (epi == EPI_RESID) {
    // residual in bf16: h = bf16(bf16(h) + bf16(y))
    *dst = bf16r(bf16r(*dst) + bf16r(y));
  } else {
    *dst = y;
  }
}

// A sum over 256 threads in the plain version's `_block_sum` order, by a
// block of any blockDim.x that is a multiple of 32 and divides 256: thread t
// stands in for threads t, t + blockDim.x, ... of the 256, each of which adds
// elements v, v + 256, ... of x [n] in turn ((x − mu)² where sq), then each
// warp folds by the xor butterfly and the eight warp totals are added in
// order
__device__ float sum256(const float* x, int n, bool sq, float mu, float* red) {
  __syncthreads();                              // red is free
  for (int v = threadIdx.x; v < 256; v += blockDim.x) {
    float s = 0.f;
    for (int i = v; i < n; i += 256) {
      if (sq) {
        const float c = x[i] - mu;
        s += c * c;
      } else {
        s += x[i];
      }
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((threadIdx.x & 31) == 0) red[v >> 5] = s;
  }
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += red[i];
  return s;
}

// One row x [n] in shared memory to int8, by the whole block: a = LN(x)·w
// (x normalized in place; w null: a = x), then the scale s = max|a|/127 +
// 1e-12 (returned) and q [n] = clip(round(a / s)) — `_ln` + `_quant_rows`
__device__ float ln_quant_row(float* x, const float* __restrict__ w, int n,
                              int8_t* q, float* red) {
  float amax = 0.f;
  if (w != nullptr) {
    const float mu = sum256(x, n, false, 0.f, red) / (float)n;
    const float var = sum256(x, n, true, mu, red) / (float)n;
    const float r = 1.f / sqrtf(var + 1e-5f);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      x[i] = (x[i] - mu) * r * __ldg(w + i);
      amax = fmaxf(amax, fabsf(x[i]));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      amax = fmaxf(amax, fabsf(x[i]));
  }
  const float s = block_max(amax, red) / 127.f + 1e-12f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) q[i] = quant_i8(x[i], s);
  return s;
}

// ln_quant_row of each row of h [R, n] into aq [R, n] and sa [R]: one block
// of 256 threads a row, staged in shared memory (n <= 3072)
__global__ void __launch_bounds__(256)
ln_quant_kernel(const float* __restrict__ h, const float* __restrict__ w,
                int8_t* __restrict__ aq, float* __restrict__ sa, int n) {
  __shared__ float red[32];
  __shared__ __align__(16) float x[3072];
  stage_async(x, h + (long long)blockIdx.x * n, n * 4);
  stage_wait();
  const float s = ln_quant_row(x, w, n, aq + (long long)blockIdx.x * n, red);
  if (threadIdx.x == 0) sa[blockIdx.x] = s;
}

// The rows an int8 product takes: quantized already (aq [R, K] int8, sa [R],
// by ln_quant_kernel or the attention's finish pass), or — x != null — float
// rows x [R, K] that every block of the product normalizes (layer norm with
// weight w; w null: none) and quantizes itself, as ln_quant_kernel would
struct Rows {
  const int8_t* aq;
  const float* sa;
  const float* x;
  const float* w;
};

// int8 GEMV: y[r, n] = (Σ_k aq[r, k]·wt[n, k]) · sa[r] · ws[n] (+ b[n]), then
// the epilogue.  A group of `lpc` lanes (a power of two <= 32) takes a
// column: lane j holds the column's 16-byte chunks j, j + lpc, ... (CH of
// them), loaded before anything else, so that the whole matrix is in flight
// while the rows are staged; a block takes blockDim / lpc columns, sized by
// the host so that every N of a layer fills the 132 SMs.  The rows' int8
// activations are staged in shared memory by cp.async, `rt` rows at a time
// (48 KB), or quantized in the block from rows.x (see Rows), which saves
// ln_quant_kernel's launch where R is small — the weights' fetch hides the
// block's normalization.  A row's sum: __dp4a over a lane's chunks, then the
// xor butterfly over the group (integers: exact in any order); lane r mod lpc
// keeps row r's sum, and the group's lanes run the epilogues of lpc rows at
// once: acc·sa·ws (+ b) in this order and store_epi, the plain version's
// `_qdot` bits under --fmad=false.
template <int CH>
__global__ void __launch_bounds__(256)
gemv_i8_staged_kernel(Rows rows, int R, const int8_t* __restrict__ wt,
                      int K, int N, const float* __restrict__ ws,
                      const float* __restrict__ bias, int epi,
                      float* __restrict__ out, int lpc, int rt) {
  extern __shared__ int4 sm_g[];  // [rt][K] int8 rows, [rt] scales (padded
                                  // to 16 bytes), rows.x: [rt][K] floats
  __shared__ float red[32];
  int8_t* act = reinterpret_cast<int8_t*>(sm_g);
  float* sa_s = reinterpret_cast<float*>(act + (long long)rt * K);
  float* xs = sa_s + ((rt + 3) & ~3);
  const int lane = threadIdx.x % lpc;
  const int n = blockIdx.x * (blockDim.x / lpc) + threadIdx.x / lpc;
  const bool live = n < N;
  const int nchunk = K / 16;
  // a column past N holds zero weights: its lanes still take part in the
  // shuffles, and store nothing
  const int4* wrow =
      reinterpret_cast<const int4*>(wt + (long long)(live ? n : 0) * K);
  int4 wv[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int ch = lane + i * lpc;
    wv[i] = live && ch < nchunk ? __ldg(wrow + ch) : make_int4(0, 0, 0, 0);
  }
  const float wsn = live ? __ldg(ws + n) : 0.f;
  const float bn = live && bias != nullptr ? __ldg(bias + n) : 0.f;
  for (int r0 = 0; r0 < R; r0 += rt) {
    const int nr = min(rt, R - r0);
    __syncthreads();                            // the last tile is done
    if (rows.x != nullptr) {
      stage_async(xs, rows.x + (long long)r0 * K, nr * K * 4);
      stage_wait();
      for (int r = 0; r < nr; ++r) {
        const float s = ln_quant_row(xs + r * K, rows.w, K, act + r * K, red);
        if (threadIdx.x == 0) sa_s[r] = s;
      }
      __syncthreads();
    } else {
      stage_async(act, rows.aq + (long long)r0 * K, nr * K);
      for (int r = threadIdx.x; r < nr; r += blockDim.x)
        sa_s[r] = rows.sa[r0 + r];
      stage_wait();
    }
    for (int g0 = 0; g0 < nr; g0 += lpc) {
      const int ng = min(lpc, nr - g0);
      int mine = 0;
      for (int rr = 0; rr < ng; ++rr) {
        const int4* a = reinterpret_cast<const int4*>(act + (g0 + rr) * K);
        int s0 = 0, s1 = 0;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const int ch = lane + i * lpc;
          if (ch < nchunk) {
            const int4 av = a[ch];
            s0 = __dp4a(wv[i].x, av.x, s0);
            s1 = __dp4a(wv[i].y, av.y, s1);
            s0 = __dp4a(wv[i].z, av.z, s0);
            s1 = __dp4a(wv[i].w, av.w, s1);
          }
        }
        int s = s0 + s1;
        for (int o = lpc >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == rr) mine = s;
      }
      if (live && lane < ng) {
        float y = (float)mine * sa_s[g0 + lane] * wsn;
        if (bias != nullptr) y = y + bn;
        store_epi(out + (long long)(r0 + g0 + lane) * N + n, y, epi);
      }
    }
  }
}

// The four nibbles of one half of a packed word sign-extended into int8
// lanes without a borrow between bytes: x | (x & 8)·0x1E sets the high
// nibble of every byte whose bit 3 is set (8·0x1E = 0xF0).  Unsigned: the
// top byte's product passes 2^31, which in int arithmetic would be an
// overflow the compiler may assume away (and then read lane 3 as unsigned).
__device__ __forceinline__ int sext_nibbles(int x) {
  const unsigned u = (unsigned)x;
  return (int)(u | ((u & 0x08080808u) * 0x1Eu));
}

// the low (shift 0) or high (shift 4) nibbles of a packed word as four
// sign-extended int8 lanes
__device__ __forceinline__ int nibble_lanes(int w, int shift) {
  return sext_nibbles((w >> shift) & 0x0F0F0F0F);
}

// W4A8 GEMV.  wt [N, K/2] output-major: column n's byte j·128 + i holds input
// row (2j)·128 + i in its low nibble and (2j+1)·128 + i in its high nibble;
// sc [N, K/128] its group scales.  A block takes `ncol` columns, chosen by
// the host so that N = 768 still gives 132 SMs work, and `rs` slices of the
// rows; a thread takes a (row slice, pair block j, column): it holds the
// pair's 128 weight bytes, unpacked once into the two groups' sign-extended
// int8 words, so a weight word loaded once serves all its rows, and it takes
// each row's two group sums whole (32 __dp4a each, in four independent
// chains: no shuffles).  The rows' int8 activations are staged in shared
// memory by cp.async, `rt` rows at a time (the host's budget; w4mq at B = 10
// has 60 rows); the threads of a warp share j, so their reads are
// broadcasts.  A thread writes its two products acc_lo·s_lo and
// acc_hi·s_hi; then one thread a (row, column) adds them in the reference's
// pair order, y = y + acc_lo·s_lo + acc_hi·s_hi, and applies y·sa (+ b) and
// the epilogue — the bits of a serial walk, under --fmad=false.
template <int NP>
__global__ void gemv_w4_kernel(const int8_t* __restrict__ aq,
                               const float* __restrict__ sa, int R,
                               const int8_t* __restrict__ wt, int K, int N,
                               const float* __restrict__ sc,
                               const float* __restrict__ bias, int epi,
                               float* __restrict__ out, int ncol, int rt) {
  extern __shared__ int4 act[];                 // [rt][K] int8, then terms
  float* terms = reinterpret_cast<float*>(act + rt * (K / 16));
  const int per_slice = ncol * NP;
  const int rs = blockDim.x / per_slice;        // row slices
  const int slice = threadIdx.x / per_slice;
  const int c = threadIdx.x % ncol, j = threadIdx.x % per_slice / ncol;
  const int n = blockIdx.x * ncol + c;
  const bool live = n < N;
  int wl[32], wh[32];
  float s_lo = 0.f, s_hi = 0.f;
  if (live) {
    const int4* wp =
        reinterpret_cast<const int4*>(wt + (long long)n * (K / 2) + j * 128);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 v = __ldg(wp + k);
      const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        wl[4 * k + u] = sext_nibbles(x[u] & 0x0F0F0F0F);
        wh[4 * k + u] = sext_nibbles((x[u] >> 4) & 0x0F0F0F0F);
      }
    }
    s_lo = __ldg(sc + (long long)n * 2 * NP + 2 * j);
    s_hi = __ldg(sc + (long long)n * 2 * NP + 2 * j + 1);
  }
  const int kc = K / 16;                        // int4 chunks of a row
  for (int r0 = 0; r0 < R; r0 += rt) {
    const int rows = min(rt, R - r0);
    __syncthreads();                            // the last tile is done
    stage_async(act, aq + (long long)r0 * K, rows * K);
    stage_wait();
    if (live) {
      for (int r = slice; r < rows; r += rs) {
        const int4* alo = act + r * kc + 2 * j * 8;
        const int4* ahi = alo + 8;
        int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int4 a = alo[k], b = ahi[k];
          lo[0] = __dp4a(wl[4 * k + 0], a.x, lo[0]);
          lo[1] = __dp4a(wl[4 * k + 1], a.y, lo[1]);
          lo[2] = __dp4a(wl[4 * k + 2], a.z, lo[2]);
          lo[3] = __dp4a(wl[4 * k + 3], a.w, lo[3]);
          hi[0] = __dp4a(wh[4 * k + 0], b.x, hi[0]);
          hi[1] = __dp4a(wh[4 * k + 1], b.y, hi[1]);
          hi[2] = __dp4a(wh[4 * k + 2], b.z, hi[2]);
          hi[3] = __dp4a(wh[4 * k + 3], b.w, hi[3]);
        }
        float* t = terms + ((long long)r * ncol + c) * 2 * NP + 2 * j;
        t[0] = (float)(lo[0] + lo[1] + lo[2] + lo[3]) * s_lo;
        t[1] = (float)(hi[0] + hi[1] + hi[2] + hi[3]) * s_hi;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * ncol; i += blockDim.x) {
      const int r = i / ncol, nn = blockIdx.x * ncol + i % ncol;
      if (nn >= N) continue;
      const float* t = terms + (long long)i * 2 * NP;
      float y = 0.f;
#pragma unroll
      for (int g = 0; g < NP; ++g) y = y + t[2 * g] + t[2 * g + 1];
      y = y * sa[r0 + r];
      if (bias != nullptr) y = y + bias[nn];
      store_epi(out + (long long)(r0 + r) * N + nn, y, epi);
    }
  }
}

// One layer's OAR KV cache.  int8 (ks == null): rows of H·Dh bytes on the
// fixed 1/16 grid.  int4 (ks != null): rows of H·Dh/2 nibble-pair bytes in
// the halves layout plus the scale planes ks / vs, [S, H] float32 per scene.
struct Cache {
  int8_t* k;
  int8_t* v;
  long long batch_stride;     // bytes between scenes
  float* ks;
  float* vs;
  long long sc_batch_stride;  // floats between scenes
};

__device__ __forceinline__ int quant_i4(float xb, float inv) {
  return (int)fminf(fmaxf(rintf(xb * inv), -7.f), 7.f);
}

// Per scene b (one block): store the chunk's K/V rows into the caches at
// cache_len (int8: bf16-rounded, x16, round, clip; int4: per (row, head)
// absmax scale of the bf16-rounded values, nibbles packed in the halves
// layout), quantize the chunk's queries with one scale per scene, and fold
// the intra-chunk causal attention (query i over chunk keys j <= i) into the
// flash state (m0, den0, acc0).  cq = scale/16 (int8) or scale/7 (int4).
// Flags, for the int8 cache: STEP_ROWS_F32 puts the new rows on the grid from
// their float32 values (TPU v6) instead of their bf16 rounding;
// STEP_HEAD_SCALE quantizes the queries with one scale per (scene, head)
// (TPU v7) instead of one per scene.  factor [B, H] holds sq·cq per head
// either way.
constexpr int STEP_HEAD_SCALE = 1;
constexpr int STEP_ROWS_F32 = 2;

// The scene's Q queries on the int8 grid: one scale a scene, sq = max|q|/127
// + 1e-12 (amax: this thread's part of max|q|), or one a (scene, head) with
// STEP_HEAD_SCALE; sqh [H] (shared) gets the scales, f [H] the factors s·cq,
// qdst [Q·HD] the int8 queries.  base: the scene's qkv rows.
__device__ void quantize_queries(const float* base, int Q, int H, int Dh,
                                 int flags, float cq, float amax, float* red,
                                 float* sqh, float* f, int8_t* qdst) {
  const int HD = H * Dh;
  const float sq = block_max(amax, red) / 127.f + 1e-12f;
  for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
    float s = sq;
    if (flags & STEP_HEAD_SCALE) {
      float hmax = 0.f;
      for (int qi = 0; qi < Q; ++qi)
        for (int d = 0; d < Dh; ++d)
          hmax = fmaxf(hmax,
                       fabsf(base[(long long)qi * 3 * HD + hh * Dh + d]));
      s = hmax / 127.f + 1e-12f;
    }
    sqh[hh] = s;
    f[hh] = s * cq;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q * HD; i += blockDim.x) {
    const int qi = i / HD, e = i % HD;
    qdst[i] = quant_i8(base[(long long)qi * 3 * HD + e], sqh[e / Dh]);
  }
}

// The prep pass of the integer caches for scene b, by a block of 256 threads
__device__ void prep_scene(int b, const float* __restrict__ qkv, int Q, int H,
                           int Dh, const Cache& c, int cl, float scale,
                           float cq, int flags, int8_t* __restrict__ qp,
                           float* __restrict__ factor, float* __restrict__ m0,
                           float* __restrict__ den0,
                           float* __restrict__ acc0) {
  __shared__ float red[32];
  __shared__ float sqh[ATT_THREADS];   // per-head query scales (H <= 128)
  const int HD = H * Dh;
  const float* base = qkv + (long long)b * Q * 3 * HD;
  const bool rows_f32 = (flags & STEP_ROWS_F32) != 0;
  float amax = 0.f;
  for (int i = threadIdx.x; i < Q * HD; i += blockDim.x) {
    const int qi = i / HD, e = i % HD;
    const float* row = base + (long long)qi * 3 * HD;
    if (c.ks == nullptr) {
      const long long dst =
          b * c.batch_stride + (long long)(cl + qi) * HD + e;
      const float kx = rows_f32 ? row[HD + e] : bf16r(row[HD + e]);
      const float vx = rows_f32 ? row[2 * HD + e] : bf16r(row[2 * HD + e]);
      c.k[dst] = (int8_t)fminf(fmaxf(rintf(kx * 16.f), -127.f), 127.f);
      c.v[dst] = (int8_t)fminf(fmaxf(rintf(vx * 16.f), -127.f), 127.f);
    }
    amax = fmaxf(amax, fabsf(row[e]));
  }
  if (c.ks != nullptr) {
    // task t, one warp: (row qi, head pair hp = heads hp and hp + H/2, K or
    // V); its lanes take the head's values d = lane, lane + 32 (Dh <= 64),
    // and the absmax goes round the warp (a maximum in any order is exact)
    const int H2 = H / 2, lane = threadIdx.x & 31;
    for (int t = threadIdx.x >> 5; t < Q * H; t += blockDim.x >> 5) {
      const int isv = t & 1, hp = (t >> 1) % H2, qi = (t >> 1) / H2;
      const float* lo = base + (long long)qi * 3 * HD + (isv + 1) * HD +
                        hp * Dh;
      const float* hi = lo + H2 * Dh;
      float s_lo = 0.f, s_hi = 0.f;
      for (int d = lane; d < Dh; d += 32) {
        s_lo = fmaxf(s_lo, fabsf(bf16r(lo[d])));
        s_hi = fmaxf(s_hi, fabsf(bf16r(hi[d])));
      }
      for (int o = 16; o > 0; o >>= 1) {
        s_lo = fmaxf(s_lo, __shfl_xor_sync(0xffffffffu, s_lo, o));
        s_hi = fmaxf(s_hi, __shfl_xor_sync(0xffffffffu, s_hi, o));
      }
      s_lo = s_lo + 1e-12f;
      s_hi = s_hi + 1e-12f;
      const float i_lo = 7.f / s_lo, i_hi = 7.f / s_hi;
      int8_t* dst = (isv ? c.v : c.k) + b * c.batch_stride +
                    (long long)(cl + qi) * (HD / 2) + hp * Dh;
      for (int d = lane; d < Dh; d += 32)
        dst[d] = (int8_t)((quant_i4(bf16r(hi[d]), i_hi) * 16) |
                          (quant_i4(bf16r(lo[d]), i_lo) & 0xF));
      if (lane == 0) {
        float* sd = (isv ? c.vs : c.ks) + b * c.sc_batch_stride +
                    (long long)(cl + qi) * H;
        sd[hp] = s_lo;
        sd[hp + H2] = s_hi;
      }
    }
  }
  quantize_queries(base, Q, H, Dh, flags, cq, amax, red, sqh, factor + b * H,
                   qp + (long long)b * Q * HD);
  // the chunk's causal weights p = exp(l − m) a (query, head), then the
  // value sums one thread a lane: acc = Σ_j p_j·v_j from 0, in j's order
  __shared__ float pw[MAX_Q * ATT_THREADS];     // [Q·H][MAX_Q]
  for (int pr = threadIdx.x; pr < Q * H; pr += blockDim.x) {
    const int qi = pr / H, hh = pr % H;
    const float* qrow = base + (long long)qi * 3 * HD + hh * Dh;
    float lj[MAX_Q];
    float mx = -CUDART_INF_F;
    for (int j = 0; j <= qi; ++j) {
      const float* krow = base + (long long)j * 3 * HD + HD + hh * Dh;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s += qrow[d] * krow[d];
      lj[j] = s * scale;
      mx = fmaxf(mx, lj[j]);
    }
    float den = 0.f;
    for (int j = 0; j <= qi; ++j) {
      const float p = expf(lj[j] - mx);
      den += p;
      pw[pr * MAX_Q + j] = p;
    }
    m0[(long long)b * Q * H + pr] = mx;
    den0[(long long)b * Q * H + pr] = den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q * HD; i += blockDim.x) {
    const int qi = i / HD, e = i % HD;
    const float* p = pw + (qi * H + e / Dh) * MAX_Q;
    float a = 0.f;
    for (int j = 0; j <= qi; ++j)
      a += p[j] * base[(long long)j * 3 * HD + 2 * HD + e];
    acc0[(long long)b * Q * HD + i] = a;
  }
}

// ---------------------------------------------------------------------------
// Prefix attention on the reference's S-blocks, for every entry: integer
// logits on the int8 and the int4 cache (v5, v5mq, w4, w4mq, v3, v4, v6, v7;
// v5i4, v5mqi4, w4i4, w4mqi4) and float logits on the dense caches read as
// bf16 (TPU v2, and v1 with `whole`; one new row a scene, Q = 1).  `_kernel_w4` / `_kernel_v5i4` / `_kernel_v2` and the plain versions
// walk S-blocks of `bs` rows (`pick_block_s`, passed by the wrapper): per block
// the maximum of the logits, m' = max(m, block max), p = exp(logit − m'), den =
// den·exp(m − m') + Σ p, acc = acc·exp(m − m') + Σ w·v.
//   * int8 cache: logit = li·factor, w·v = bf16(p)·(v/16);
//   * int4 cache: logit = (li·ks[row, head])·factor, w·v = bf16(p·vs[row,
//     head]·(1/7))·q with q the value nibble;
//   * dense (v2): q rounded to bf16, logit = Σ_d bf16(k_d·q_d) in float32 ×
//     scale, the self logit from bf16(k_new·q) seeding the state (m = self
//     logit, den = 1, acc = v_new), w·v = bf16(bf16(p)·v), the block's sum
//     of w·v rounded to bf16, the rescale exp(m − m') rounded to bf16 where it
//     multiplies acc, and y = acc / bf16(den);
//   * dense, `whole` (v1): one block over all of S, m the maximum of every
//     logit and the self logit, denom = Σ exp(logit − m) + exp(self − m), w·v
//     = bf16(bf16(exp(logit − m) / denom)·v), y = bf16(Σ w·v) + bf16(es /
//     denom)·v_new with es = exp(self − m).
// Here the S-blocks are cut into sub-blocks of SUB_ROWS rows, each a CUDA
// block, and the caches differ only in how a staged row is read and where the
// roundings fall (the template's KIND):
//   i8_blockmax_kernel — the sub-block's logits (K rows, and on the int4
//     cache their scales, staged in shared memory; the scene's queries
//     quantized, or rounded to bf16, in the block), written out for the next
//     pass, and their maximum per (query, head); its block x = 0 runs the
//     scene's prep pass (the new rows into the cache; the intra-chunk causal
//     state, or the dense self term);
//   i8_mix_kernel — m' of the sub-block's S-block (the maxima of every sub-
//     block up to the block's end, from the intra-chunk or self m), the
//     weights p from the logits (Q·H floats a row, not the row's key bytes),
//     their float32 sum (v1: the denominator, taken again in every block from
//     exp(logit − m) of every row, so that it is the reference's sum of the
//     reference's terms), the rounded weights w, and the value sums Σ w·v, one
//     thread four lanes, on V rows staged in shared memory while the weights
//     are computed;
//   i8_finish_kernel — one thread a lane of H·Dh a (scene, query): folds the
//     sub-blocks S-block by S-block from the prep pass's state, y, the row's
//     maximum by a block reduction, and the int8 quantization of y for the
//     output projection.
// Integer caches: the products w·v are exact in float32 (a bf16 value times an
// integer of at most 8 bits).  Dense: each w·v is rounded to bf16 as the
// reference rounds it.  Either way only the order of the float32 sums inside an
// S-block (and of a logit's Dh products) differs from the reference's.  The
// plain version sums in PyTorch's order, so y's int8 quantization can flip at
// a near tie (pinned by tests/test_torch_cuda.py::test_w4mq_flip_is_a_near_tie).
constexpr int CACHE_INT8 = 0;     // rows of H·Dh bytes on the 1/16 grid
constexpr int CACHE_INT4 = 1;     // rows of H·Dh/2 nibble pairs + scale planes
constexpr int CACHE_BF16 = 2;     // dense: bf16 rows
constexpr int CACHE_FP8 = 3;      // dense: fp8 (e4m3) rows, read as bf16
constexpr int CACHE_GRID8 = 4;    // dense: int8 rows on the 1/16 grid, read
                                  // as bf16 (TPU v2, not v5's integer logits)
constexpr int SUB_ROWS = 32;      // cache rows of one sub-block

__host__ __device__ constexpr bool dense_kind(int kind) {
  return kind >= CACHE_BF16;
}

// bytes of one cached value of a dense kind
__host__ __device__ constexpr int dense_bytes(int kind) {
  return kind == CACHE_BF16 ? 2 : 1;
}

// bytes of one cached row of H·Dh values
template <int KIND>
__host__ __device__ __forceinline__ int cache_row_bytes(int HD) {
  return KIND == CACHE_INT4 ? HD / 2 : dense_kind(KIND) ? HD * dense_bytes(KIND)
                                                        : HD;
}

// four consecutive values of a dense row at p (8 or 4 bytes, aligned), as
// float: bf16 as it is, fp8 through its exact half value, int8 times 1/16
template <int KIND>
__device__ __forceinline__ void dense4(const int8_t* p, float v[4]) {
  if constexpr (KIND == CACHE_BF16) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const int x = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int byte = (x >> (8 * u)) & 0xff;
      if constexpr (KIND == CACHE_FP8) {
        const __half_raw hr = __nv_cvt_fp8_to_halfraw(
            (__nv_fp8_storage_t)byte, __NV_E4M3);
        v[u] = __half2float(__half(hr));
      } else {
        v[u] = (float)(int8_t)byte * 0.0625f;
      }
    }
  }
}

// xb, a bf16 value, into a dense row at i.  fp8: a second rounding, saturating
// at ±448 as PyTorch's conversion does; int8: round(xb·16), clip.
template <int KIND>
__device__ __forceinline__ void dense_put(int8_t* row, int i, float xb) {
  if constexpr (KIND == CACHE_BF16) {
    reinterpret_cast<__nv_bfloat16*>(row)[i] = __float2bfloat16_rn(xb);
  } else if constexpr (KIND == CACHE_FP8) {
    reinterpret_cast<__nv_fp8_storage_t*>(row)[i] =
        __nv_cvt_float_to_fp8(xb, __NV_SATFINITE, __NV_E4M3);
  } else {
    row[i] = (int8_t)fminf(fmaxf(rintf(xb * 16.f), -127.f), 127.f);
  }
}

// The dense steps' prep pass for scene b (Q = 1), by one block: the new K/V
// row into the cache at cl (its bf16 rounding, stored in the cache's type),
// the self logit Σ_d bf16(k_d·q_d) × scale a head into m0 (a product of two
// float32 values rounded to bf16: the reference's bf16(k_new·q)), and the
// state's den0 = 1 and acc0 = v_new (float32)
template <int KIND>
__device__ void dense_prep_scene(int b, const float* __restrict__ qkv, int H,
                                 int Dh, const Cache& c, int cl, float scale,
                                 float* __restrict__ m0,
                                 float* __restrict__ den0,
                                 float* __restrict__ acc0) {
  const int HD = H * Dh;
  const float* row = qkv + (long long)b * 3 * HD;
  const long long dst =
      b * c.batch_stride + (long long)cl * cache_row_bytes<KIND>(HD);
  for (int e = threadIdx.x; e < HD; e += blockDim.x) {
    dense_put<KIND>(c.k + dst, e, bf16r(row[HD + e]));
    dense_put<KIND>(c.v + dst, e, bf16r(row[2 * HD + e]));
    acc0[(long long)b * HD + e] = row[2 * HD + e];
  }
  for (int hh = threadIdx.x; hh < H; hh += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < Dh; ++d)
      s += bf16r(row[HD + hh * Dh + d] * row[hh * Dh + d]);
    m0[b * H + hh] = s * scale;
    den0[b * H + hh] = 1.f;
  }
}

// rows of sub-block k (S-block k / nsub_per, part k % nsub_per) below cl
__device__ __forceinline__ int sub_rows(int k, int bs, int nsub_per, int cl,
                                        int* s0) {
  const int j = k / nsub_per;
  *s0 = j * bs + (k % nsub_per) * SUB_ROWS;
  return max(0, min(min(cl, (j + 1) * bs), *s0 + SUB_ROWS) - *s0);
}

template <int KIND, int DH>
__global__ void __launch_bounds__(256)
i8_blockmax_kernel(Cache c, int cl, int S, int Q, int H, int bs,
                   int nsub_per, int nsubT, const float* __restrict__ qkv,
                   float scale, float cq, int flags,
                   int8_t* __restrict__ qp, float* __restrict__ factor,
                   float* __restrict__ m0, float* __restrict__ den0,
                   float* __restrict__ acc0, float* __restrict__ ilog,
                   float* __restrict__ pmax) {
  extern __shared__ int4 sm4[];   // [Q·HD] int8 queries (dense: [HD] bf16
                                  // queries as float), [32][RB] K rows, int4:
                                  // [32][H] K scales; [32][QH] logits,
                                  // [256 / QH][QH] partial maxima
  __shared__ float red32[32], sqh[ATT_THREADS], fh_s[ATT_THREADS];
  constexpr int W = DH / 16;
  constexpr bool DENSE = dense_kind(KIND);
  const int b = blockIdx.y;
  if (blockIdx.x == 0) {          // the prep pass of scene b rides along
    if constexpr (DENSE)
      dense_prep_scene<KIND>(b, qkv, H, DH, c, cl, scale, m0, den0, acc0);
    else
      prep_scene(b, qkv, Q, H, DH, c, cl, scale, cq, flags, qp, factor, m0,
                 den0, acc0);
    return;
  }
  const int blk = blockIdx.x - 1;
  const int HD = H * DH, QH = Q * H, RB = cache_row_bytes<KIND>(HD);
  int s0;
  const int rows = sub_rows(blk, bs, nsub_per, cl, &s0);
  if (rows == 0) return;
  int8_t* qs = reinterpret_cast<int8_t*>(sm4);
  float* qf = reinterpret_cast<float*>(sm4);
  int8_t* kb = qs + (DENSE ? HD * 4 : Q * HD);
  float* ksc = reinterpret_cast<float*>(kb + SUB_ROWS * RB);
  float* lg = ksc + (KIND == CACHE_INT4 ? SUB_ROWS * H : 0);
  if (KIND == CACHE_INT4)
    stage_async_f32(ksc, c.ks + b * c.sc_batch_stride + (long long)s0 * H,
                    rows * H);
  stage_async(kb, c.k + b * c.batch_stride + (long long)s0 * RB, rows * RB);
  const float* base = qkv + (long long)b * Q * 3 * HD;
  if constexpr (DENSE) {
    for (int e = threadIdx.x; e < HD; e += blockDim.x) qf[e] = bf16r(base[e]);
  } else {
    // the scene's queries, quantized here as the prep pass quantizes them
    float amax = 0.f;
    for (int i = threadIdx.x; i < Q * HD; i += blockDim.x)
      amax = fmaxf(amax, fabsf(base[(long long)(i / HD) * 3 * HD + i % HD]));
    quantize_queries(base, Q, H, DH, flags, cq, amax, red32, sqh, fh_s, qs);
  }
  stage_wait();
  // one thread a (row, head): its K slice against the Q queries
  for (int t = threadIdx.x; t < rows * H; t += blockDim.x) {
    const int r = t / H, hh = t % H;
    if constexpr (DENSE) {
      // a product of two bf16 values is exact in float32, so bf16r of it is
      // the reference's bf16 product
      const int8_t* krow = kb + r * RB + hh * DH * dense_bytes(KIND);
      const float* q = qf + hh * DH;
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < DH / 4; ++g) {
        float kv[4];
        dense4<KIND>(krow + 4 * g * dense_bytes(KIND), kv);
#pragma unroll
        for (int u = 0; u < 4; ++u) s += bf16r(kv[u] * q[4 * g + u]);
      }
      lg[r * QH + hh] = s * scale;
    } else {
      // int4: the head's DH values are bytes (hh mod H/2)·DH.. of the row, in
      // the low nibbles for hh < H/2 and the high ones otherwise (the halves
      // layout)
      int4 kv[W];
      if (KIND == CACHE_INT4) {
        const int4* krow = reinterpret_cast<const int4*>(
            kb + r * RB + (hh % (H / 2)) * DH);
        const int shift = hh < H / 2 ? 0 : 4;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int4 p = krow[w];
          kv[w] = make_int4(nibble_lanes(p.x, shift), nibble_lanes(p.y, shift),
                            nibble_lanes(p.z, shift), nibble_lanes(p.w, shift));
        }
      } else {
        const int4* krow = reinterpret_cast<const int4*>(kb + r * HD + hh * DH);
#pragma unroll
        for (int w = 0; w < W; ++w) kv[w] = krow[w];
      }
      const float fh = fh_s[hh];
      const float ksr = KIND == CACHE_INT4 ? ksc[r * H + hh] : 1.f;
      for (int qi = 0; qi < Q; ++qi) {
        const int4* qv = reinterpret_cast<const int4*>(qs + qi * HD + hh * DH);
        int li = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int4 a = qv[w];
          li = __dp4a(kv[w].x, a.x, li);
          li = __dp4a(kv[w].y, a.y, li);
          li = __dp4a(kv[w].z, a.z, li);
          li = __dp4a(kv[w].w, a.w, li);
        }
        // int4: (li·ks)·factor, the plain version's li·ksb·fac
        lg[r * QH + qi * H + hh] =
            KIND == CACHE_INT4 ? ((float)li * ksr) * fh : (float)li * fh;
      }
    }
  }
  __syncthreads();
  float* dst = ilog + ((long long)b * S + s0) * QH;
  for (int t = threadIdx.x; t < rows * QH; t += blockDim.x) dst[t] = lg[t];
  // the maximum over the rows, `parts` threads a (query, head)
  float* red = lg + SUB_ROWS * QH;              // [parts][QH]
  const int parts = blockDim.x / QH;
  if (threadIdx.x < parts * QH) {
    const int qh = threadIdx.x % QH, pt = threadIdx.x / QH;
    float mx = -CUDART_INF_F;
    for (int r = pt; r < rows; r += parts) mx = fmaxf(mx, lg[r * QH + qh]);
    red[pt * QH + qh] = mx;
  }
  __syncthreads();
  for (int qh = threadIdx.x; qh < QH; qh += blockDim.x) {
    float mx = -CUDART_INF_F;
    for (int pt = 0; pt < parts; ++pt) mx = fmaxf(mx, red[pt * QH + qh]);
    pmax[((long long)b * nsubT + blk) * QH + qh] = mx;
  }
}

template <int KIND, int DH, int MAXQ>
__global__ void __launch_bounds__(256)
i8_mix_kernel(Cache c, int cl, int S, int Q, int H, int bs, int nsub_per,
              int nsubT, int whole, const float* __restrict__ ilog,
              const float* __restrict__ m0, const float* __restrict__ pmax,
              float* __restrict__ psum, float* __restrict__ pacc) {
  extern __shared__ int4 sm4[];   // [32][RB] V rows, int4: [32][H] V scales;
                                  // [32][QH] weights, [QH] m', [QH] v1's
                                  // denominators, [256 / QH][QH] partial
                                  // maxima and sums
  constexpr bool DENSE = dense_kind(KIND);
  const int blk = blockIdx.x, b = blockIdx.y;
  const int HD = H * DH, QH = Q * H, RB = cache_row_bytes<KIND>(HD);
  int s0;
  const int rows = sub_rows(blk, bs, nsub_per, cl, &s0);
  if (rows == 0) return;
  int8_t* vb = reinterpret_cast<int8_t*>(sm4);
  float* vsc = reinterpret_cast<float*>(vb + SUB_ROWS * RB);
  float* lg = vsc + (KIND == CACHE_INT4 ? SUB_ROWS * H : 0);
  float* mnew = lg + SUB_ROWS * QH;
  float* dens = mnew + QH;
  // int4: the V scales first, in a commit group of their own (the weights
  // need them), then the V rows, which the value sums need last
  if (KIND == CACHE_INT4)
    stage_async_f32(vsc, c.vs + b * c.sc_batch_stride + (long long)s0 * H,
                    rows * H);
  stage_async(vb, c.v + b * c.batch_stride + (long long)s0 * RB, rows * RB);
  // m' of this S-block: the intra-chunk (or self) maximum and every
  // sub-block's up to the block's end (the maximum is exact in any order),
  // the sub-blocks shared out over all threads, `parts` of them a (query,
  // head)
  float* red = dens + QH;                       // [parts][QH]
  const int parts = blockDim.x / QH;
  const int kend = (blk / nsub_per + 1) * nsub_per;
  if (threadIdx.x < parts * QH) {
    const int qh = threadIdx.x % QH, pt = threadIdx.x / QH;
    const float* pm = pmax + (long long)b * nsubT * QH + qh;
    float m = -CUDART_INF_F;
    for (int k = pt; k < kend; k += parts) {
      int k0;
      if (sub_rows(k, bs, nsub_per, cl, &k0) > 0) m = fmaxf(m, pm[k * QH]);
    }
    red[pt * QH + qh] = m;
  }
  __syncthreads();
  for (int qh = threadIdx.x; qh < QH; qh += blockDim.x) {
    float m = m0[(long long)b * QH + qh];
    for (int pt = 0; pt < parts; ++pt) m = fmaxf(m, red[pt * QH + qh]);
    mnew[qh] = m;
  }
  __syncthreads();
  const float* src = ilog + ((long long)b * S + s0) * QH;
  for (int t = threadIdx.x; t < rows * QH; t += blockDim.x)
    lg[t] = expf(src[t] - mnew[t % QH]);
  if (DENSE && whole) {
    // v1: denom = Σ exp(logit − m) over every row below cl, + exp(self − m),
    // m the maximum of them all (one S-block: m' above); the same float32
    // sum in every block.  The scene's logits [cl][QH] as float4s, BATCH
    // loads in flight a thread (the loads' latency, not the exps, bounds
    // this: at QH = 16 one round covers 1536 rows, two the whole cache);
    // thread t always meets heads (4t mod QH)..+3
    // (QH a power of two, 4..32), the lanes that share them fold by the xor
    // butterfly, then the warps' sums in order
    constexpr int BATCH = 24;
    const int n4 = cl * QH / 4, h0 = 4 * threadIdx.x % QH;
    const float4* la = reinterpret_cast<const float4*>(
        ilog + (long long)b * S * QH);
    const float m[4] = {mnew[h0], mnew[h0 + 1], mnew[h0 + 2], mnew[h0 + 3]};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float ninf = -CUDART_INF_F;
    for (int i0 = threadIdx.x; i0 < n4; i0 += BATCH * blockDim.x) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int i = i0 + u * blockDim.x;
        v[u] = i < n4 ? la[i] : make_float4(ninf, ninf, ninf, ninf);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {    // exp(−inf) adds 0
        s[0] += expf(v[u].x - m[0]);
        s[1] += expf(v[u].y - m[1]);
        s[2] += expf(v[u].z - m[2]);
        s[3] += expf(v[u].w - m[3]);
      }
    }
    for (int o = 16; o >= QH / 4; o >>= 1)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    if (lane < QH / 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) red[wp * QH + h0 + u] = s[u];
    __syncthreads();
    for (int qh = threadIdx.x; qh < QH; qh += blockDim.x) {
      float t = 0.f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w * QH + qh];
      dens[qh] = t + expf(m0[(long long)b * QH + qh] - mnew[qh]);
    }
  }
  if (KIND == CACHE_INT4)
    stage_wait_but_last();                      // the V scales are in
  else
    __syncthreads();
  // Σ p in float32 (`parts` threads a (query, head), row r to part r mod
  // parts, their partial sums added in order), then the weights rounded to
  // bf16 in place: int8 bf16(p)/16 (exact: bf16(p)/16 · v is the reference's
  // bf16(p) · (v/16)), int4 bf16(p·vs·(1/7)) from the unrounded p, dense
  // bf16(p), v1 bf16(p / denom) (its Σ p unused: the block's denominator
  // goes out in its place)
  const float inv7 = (float)(1.0 / 7.0);
  if (threadIdx.x < parts * QH) {
    const int qh = threadIdx.x % QH, pt = threadIdx.x / QH, hh = qh % H;
    float ps = 0.f;
    for (int r = pt; r < rows; r += parts) {
      const float p = lg[r * QH + qh];
      ps += p;
      float w;
      if constexpr (KIND == CACHE_INT4)
        w = bf16r(p * vsc[r * H + hh] * inv7);
      else if constexpr (DENSE)
        w = bf16r(whole ? p / dens[qh] : p);
      else
        w = bf16r(p) * 0.0625f;
      lg[r * QH + qh] = w;
    }
    red[pt * QH + qh] = ps;
  }
  __syncthreads();
  for (int qh = threadIdx.x; qh < QH; qh += blockDim.x) {
    float ps = 0.f;
    for (int pt = 0; pt < parts; ++pt) ps += red[pt * QH + qh];
    psum[((long long)b * nsubT + blk) * QH + qh] =
        DENSE && whole ? dens[qh] : ps;
  }
  stage_wait();
  // four lanes a thread: one 32-bit word of a V row (int4: of the row's
  // low-nibble half for lanes below HD/2, of its high-nibble half above;
  // bf16: two words), one weight a query
  float* dst = pacc + ((long long)b * nsubT + blk) * Q * HD;
  for (int e0 = 4 * threadIdx.x; e0 < HD; e0 += 4 * blockDim.x) {
    const int hh = e0 / DH;
    float acc[MAXQ][4];
#pragma unroll
    for (int qi = 0; qi < MAXQ; ++qi)
      acc[qi][0] = acc[qi][1] = acc[qi][2] = acc[qi][3] = 0.f;
    if constexpr (DENSE) {
      // each product w·v rounded to bf16, as the reference rounds it
      const int8_t* vcol = vb + e0 * dense_bytes(KIND);
      for (int r = 0; r < rows; ++r) {
        float v[4];
        dense4<KIND>(vcol + r * RB, v);
        const float w = lg[r * QH + hh];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[0][u] = acc[0][u] + bf16r(w * v[u]);
      }
    } else {
      const bool high = KIND == CACHE_INT4 && e0 >= HD / 2;
      const int8_t* vcol = vb + (high ? e0 - HD / 2 : e0);
      for (int r = 0; r < rows; ++r) {
        int x = *reinterpret_cast<const int*>(vcol + r * RB);
        if (KIND == CACHE_INT4) x = nibble_lanes(x, high ? 4 : 0);
        const float v[4] = {(float)(int8_t)x, (float)(int8_t)(x >> 8),
                            (float)(int8_t)(x >> 16),
                            (float)(int8_t)(x >> 24)};
        const float* wr = lg + r * QH + hh;
#pragma unroll
        for (int qi = 0; qi < MAXQ; ++qi) {
          if (qi < Q) {
            const float w = wr[qi * H];
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[qi][u] = acc[qi][u] + w * v[u];
          }
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < MAXQ; ++qi)
      if (qi < Q)
        *reinterpret_cast<float4*>(dst + (long long)qi * HD + e0) =
            make_float4(acc[qi][0], acc[qi][1], acc[qi][2], acc[qi][3]);
  }
}

// the finish pass's roundings (see the section's head)
constexpr int FOLD_INT = 0;       // integer logits
constexpr int FOLD_DENSE = 1;     // dense, S-blocks (v2)
constexpr int FOLD_WHOLE = 2;     // dense, one block, normalized weights (v1)

// one block a (query qi, scene b), one thread a lane e of H·Dh (up to 1024,
// so at most 64 registers); the loads of an S-block's sub-blocks are issued
// FOLD at a time
constexpr int FOLD = 8;
__global__ void __launch_bounds__(1024)
i8_finish_kernel(int Q, int H, int Dh, int cl, int bs, int nb, int nsub_per,
                 int nsubT, int mode, const float* __restrict__ m0,
                 const float* __restrict__ den0,
                 const float* __restrict__ acc0,
                 const float* __restrict__ pmax,
                 const float* __restrict__ psum,
                 const float* __restrict__ pacc, int8_t* __restrict__ yq,
                 float* __restrict__ sa) {
  __shared__ float red[32];
  const int qi = blockIdx.x, b = blockIdx.y, e = threadIdx.x;
  const int HD = H * Dh, QH = Q * H, qh = qi * H + e / Dh;
  const long long row = (long long)b * Q + qi;
  float m = m0[(long long)b * QH + qh], den = den0[(long long)b * QH + qh];
  float acc = acc0[row * HD + e];
  for (int j = 0; j < nb; ++j) {
    const int n = (min(cl, (j + 1) * bs) - j * bs + SUB_ROWS - 1) / SUB_ROWS;
    const long long k0 = (long long)b * nsubT + j * nsub_per;
    const float* pm = pmax + k0 * QH + qh;      // a sub-block QH floats on
    const float* pl = psum + k0 * QH + qh;
    const float* pa = pacc + (k0 * Q + qi) * HD + e;   // Q·HD floats on
    const int pa_step = Q * HD;
    float bm = -CUDART_INF_F, ps[4] = {0.f, 0.f, 0.f, 0.f};
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < n; i0 += FOLD) {
      float vm[FOLD], vl[FOLD], va[FOLD];
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        const bool in = i0 + u < n;
        vm[u] = in ? pm[(i0 + u) * QH] : -CUDART_INF_F;
        vl[u] = in ? pl[(i0 + u) * QH] : 0.f;
        va[u] = in ? pa[(i0 + u) * pa_step] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < FOLD; ++u) {
        bm = fmaxf(bm, vm[u]);
        ps[u % 4] += vl[u];
        part[u % 4] += va[u];
      }
    }
    const float mnew = fmaxf(m, bm);
    const float corr = expf(m - mnew);
    const float psj = (ps[0] + ps[1]) + (ps[2] + ps[3]);
    const float pj = (part[0] + part[1]) + (part[2] + part[3]);
    if (mode == FOLD_INT) {
      den = den * corr + psj;
      acc = acc * corr + pj;
    } else if (mode == FOLD_DENSE) {
      den = den * corr + psj;
      acc = acc * bf16r(corr) + bf16r(pj);
    } else {      // one block: corr = es, acc = v_new, pl[0] the denominator
      acc = bf16r(pj) + bf16r(corr / pl[0]) * acc;
    }
    m = mnew;
  }
  const float y = mode == FOLD_INT     ? acc / den
                  : mode == FOLD_DENSE ? acc / bf16r(den)
                                       : acc;
  const float s = block_max(fabsf(y), red) / 127.f + 1e-12f;
  yq[row * HD + e] = quant_i8(y, s);
  if (e == 0) sa[row] = s;
}

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

struct Workspace {
  float* h;       // [R, d] residual stream (bf16 values in float32)
  int8_t* aq;     // [R, 4d] quantized activations
  float* sa;      // [R] activation scales
  float* qkv;     // [R, 3d]
  int8_t* qp;     // [B, Q, d] quantized queries
  float* factor;  // [B, H]
  float* m0;      // [B, Q*H] the prep pass's state: maximum (dense: self
  float* den0;    // [B, Q*H]   logit), denominator and value sums (dense:
  float* acc0;    // [B, Q, d]  1 and v_new)
  float* hid;     // [R, 4d]
  // the prefix attention, per sub-block and (query, head)
  float* lg;      // [B, S, Q*H] logits
  float* pacc;    // [B, NSUB, Q, d] float32 value sums
  float* pmax;    // [B, NSUB, Q*H] maximum of the logits
  float* psum;    // [B, NSUB, Q*H] sum of the weights (v1: the denominator)
};

// S-blocks hold at least 64 rows (or all of S), sub-blocks 32 rows
size_t max_subs(int S) { return (size_t)S / 32 + (size_t)S / 64 + 3; }

size_t workspace_layout(int B, int Q, int d, int H, int S, char* base,
                        Workspace* ws) {
  const size_t R = (size_t)B * Q;
  const size_t nsub = max_subs(S);
  constexpr int NSLOT = 14;
  const size_t sizes[NSLOT] = {
      R * d * 4,        R * 4 * d,        R * 4,
      R * 3 * d * 4,    R * d,            (size_t)B * H * 4,
      R * H * 4,        R * H * 4,        R * d * 4,
      R * 4 * d * 4,    R * S * H * 4,    R * nsub * d * 4,
      B * nsub * Q * H * 4, B * nsub * Q * H * 4};
  void** slots[NSLOT] = {
      (void**)&ws->h,    (void**)&ws->aq,   (void**)&ws->sa,
      (void**)&ws->qkv,  (void**)&ws->qp,   (void**)&ws->factor,
      (void**)&ws->m0,   (void**)&ws->den0, (void**)&ws->acc0,
      (void**)&ws->hid,  (void**)&ws->lg,   (void**)&ws->pacc,
      (void**)&ws->pmax, (void**)&ws->psum};
  size_t off = 0;
  for (int i = 0; i < NSLOT; ++i) {
    if (base != nullptr) *slots[i] = base + off;
    off += align_up(sizes[i]);
  }
  return off;
}

// The prefix attention of one layer on a cache of kind KIND, on S-blocks of
// bs rows (see i8_blockmax_kernel above); whole: v1's one normalized block.
// Three launches; the prep pass alone where there is no prefix.
template <int KIND, int DH>
cudaError_t attention(const Workspace& w, int B, int Q, int H, int S,
                      const Cache& c, int cl, int bs, int whole, float scale,
                      float cq, int flags, cudaStream_t st) {
  constexpr bool DENSE = dense_kind(KIND);
  const int HD = H * DH, QH = Q * H;
  const int nb = (cl + bs - 1) / bs;
  const int nsub_per = (bs + SUB_ROWS - 1) / SUB_ROWS;
  const int nsubT = (int)max_subs(S);
  if (nb * nsub_per > nsubT || HD > 1024 || HD % 32 || (DENSE && Q != 1))
    return cudaErrorInvalidValue;
  // a sub-block's rows, and on the int4 cache their scales, then the
  // weights (see the kernels' shared-memory maps)
  const size_t rows = SUB_ROWS * (size_t)cache_row_bytes<KIND>(HD) +
                      (KIND == CACHE_INT4 ? SUB_ROWS * H * sizeof(float) : 0);
  const size_t lg = SUB_ROWS * QH * sizeof(float);
  const size_t queries = DENSE ? HD * sizeof(float) : (size_t)Q * HD;
  const size_t smem_max = queries + rows + lg + 256 * sizeof(float);
  const size_t smem_mix = rows + lg + (2 * QH + 256) * sizeof(float);
  static bool configured = false;      // past 48 KB only when asked for
  if (!configured) {
    const int most = 96 * 1024;
    cudaFuncSetAttribute(i8_blockmax_kernel<KIND, DH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(i8_mix_kernel<KIND, DH, 1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if constexpr (!DENSE)
      cudaFuncSetAttribute(i8_mix_kernel<KIND, DH, MAX_Q>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    configured = true;
  }
  // block x = 0 of each scene runs the prep pass, the others a sub-block
  i8_blockmax_kernel<KIND, DH>
      <<<dim3(nb * nsub_per + 1, B), 256, smem_max, st>>>(
          c, cl, S, Q, H, bs, nsub_per, nsubT, w.qkv, scale, cq, flags, w.qp,
          w.factor, w.m0, w.den0, w.acc0, w.lg, w.pmax);
  if (nb > 0) {
    const dim3 grid(nb * nsub_per, B);
    // the single-row step (2196 a frame) without the chunk's query loop
    if (DENSE || Q == 1)
      i8_mix_kernel<KIND, DH, 1><<<grid, 256, smem_mix, st>>>(
          c, cl, S, Q, H, bs, nsub_per, nsubT, whole, w.lg, w.m0, w.pmax,
          w.psum, w.pacc);
    else if constexpr (!DENSE)
      i8_mix_kernel<KIND, DH, MAX_Q><<<grid, 256, smem_mix, st>>>(
          c, cl, S, Q, H, bs, nsub_per, nsubT, whole, w.lg, w.m0, w.pmax,
          w.psum, w.pacc);
  }
  const int mode = !DENSE ? FOLD_INT : whole ? FOLD_WHOLE : FOLD_DENSE;
  i8_finish_kernel<<<dim3(Q, B), HD, 0, st>>>(
      Q, H, DH, cl, bs, nb, nsub_per, nsubT, mode, w.m0, w.den0, w.acc0,
      w.pmax, w.psum, w.pacc, w.aq, w.sa);
  return cudaGetLastError();
}

template <int DH>
cudaError_t attention_of_kind(int kind, const Workspace& w, int B, int Q,
                              int H, int S, const Cache& c, int cl, int bs,
                              int whole, float scale, float cq, int flags,
                              cudaStream_t st) {
#define ATTN_CASE(KIND)                                                  \
  case KIND:                                                             \
    return attention<KIND, DH>(w, B, Q, H, S, c, cl, bs, whole, scale, cq, \
                               flags, st);
  switch (kind) {
    ATTN_CASE(CACHE_INT8) ATTN_CASE(CACHE_INT4) ATTN_CASE(CACHE_BF16)
    ATTN_CASE(CACHE_FP8) ATTN_CASE(CACHE_GRID8)
    default:
      return cudaErrorInvalidValue;
  }
#undef ATTN_CASE
}

// The four products of a layer, in order qkv, proj, fc, pj: int8 (w4 ==
// false: w[i] [N, K] output-major, per-column scales in the vector block)
// or W4A8 (w4 == true: w[i] [N, K/2] packed, s[i] [N, K/128] group scales).
// Layer l's matrix i starts at w[i] + l·w_stride[i] (s likewise).
struct Products {
  bool w4;
  const int8_t* w[4];
  long long w_stride[4];
  const float* s[4];
  long long s_stride[4];
};

// The most rows an int8 product normalizes and quantizes itself (Rows.x):
// every block of the product does all of them, which its weights' fetch
// hides at a row or two and which would cost more than ln_quant_kernel's
// launch beyond.
constexpr int LN_FUSE_ROWS = 2;

cudaError_t gemv(bool w4, const Rows& rows, int R, const int8_t* wt,
                 const float* scales, int K, int N, const float* bias,
                 int epi, float* out, cudaStream_t st) {
  if (w4) {
    if (rows.x != nullptr) return cudaErrorInvalidValue;
    // columns a block: at most 32, fewer while that leaves under 132 blocks;
    // rows a tile: as many as 48 KB of staged activations and terms hold
    const int np = K / 256;
    int ncol = 32;
    while (ncol > 1 && (N + ncol - 1) / ncol < 132) ncol /= 2;
    const int row_bytes = K + ncol * 2 * np * (int)sizeof(float);
    const int rt = min(R, max(1, 49152 / row_bytes));
    const size_t smem = (size_t)rt * row_bytes;
    const int nb = (N + ncol - 1) / ncol;
    // row slices: at least 128 threads a block, at most one slice a row
    const int rs = max(1, min(128 / (ncol * np), rt));
#define W4_CASE(NP)                                                       \
  case NP:                                                                \
    gemv_w4_kernel<NP><<<nb, ncol * NP * rs, smem, st>>>(                 \
        rows.aq, rows.sa, R, wt, K, N, scales, bias, epi, out, ncol, rt); \
    break;
    switch (np) {   // K = d or 4d, d in {256, 512, 768} (run_step)
      W4_CASE(1) W4_CASE(2) W4_CASE(3) W4_CASE(4) W4_CASE(8) W4_CASE(12)
      default:
        return cudaErrorInvalidValue;
    }
#undef W4_CASE
  } else {
    // lanes a column: enough for about three 16-byte chunks a lane, at most
    // a warp (K = 768: 16 lanes of 3; K = 3072: 32 lanes of 6); threads a
    // block: 256, fewer while that leaves under 132 blocks
    const int nchunk = K / 16;
    int lpc = 1;
    while (lpc < 32 && 3 * lpc < nchunk) lpc *= 2;
    const int ch = (nchunk + lpc - 1) / lpc;
    int bt = 256;
    while (bt > 64 && ((long long)N * lpc + bt - 1) / bt < 132) bt /= 2;
    const int ncol = bt / lpc, nb = (N + ncol - 1) / ncol;
    // rows a tile: as many as 48 KB hold with their scales (and padding)
    const bool fused = rows.x != nullptr;
    const int rt = fused ? R : min(R, max(1, (49152 - 16) / (K + 4)));
    const size_t smem = (size_t)rt * K + 4 * ((rt + 3) & ~3) +
                        (fused ? (size_t)rt * K * sizeof(float) : 0);
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
#define I8_CASE(CH)                                                  \
  case CH:                                                           \
    gemv_i8_staged_kernel<CH><<<nb, bt, smem, st>>>(                 \
        rows, R, wt, K, N, scales, bias, epi, out, lpc, rt);         \
    break;
    switch (ch) {   // K <= 3072 (run_step)
      I8_CASE(1) I8_CASE(2) I8_CASE(3) I8_CASE(4) I8_CASE(5) I8_CASE(6)
      default:
        return cudaErrorInvalidValue;
    }
#undef I8_CASE
  }
  return cudaGetLastError();
}

// The whole cache of a step: layer l's part starts l·layer_stride bytes (and
// l·sc_layer_stride floats) into the arrays of `c`.
struct StepCache {
  Cache c;
  long long layer_stride;
  long long sc_layer_stride;
};

// kind: the cache's (CACHE_*; dense kinds: kv's strides in bytes of its
// storage type, Q = 1, cq and flags unused); cq: scale/16 for the int8
// cache, scale/7 for the int4 one; flags: see prep_scene (the int8 cache
// only); bs: the S-block rows of the prefix attention; whole: v1's one
// normalized block (a dense kind, bs = S)
int run_step(const void* x, void* out, int B, int Q, int d, int H, int L,
             const float* vec, const Products& P, const StepCache& kv, int S,
             int cl, float scale, float cq, void* workspace, cudaStream_t st,
             int flags, int kind, int bs, int whole) {
  const int R = B * Q, Dh = d / H;
  if (Q > MAX_Q || Q * H > ATT_THREADS || cl + Q > S || bs < 1)
    return (int)cudaErrorInvalidValue;
  if ((kind == CACHE_INT4) != (kv.c.ks != nullptr) || kind > CACHE_GRID8)
    return (int)cudaErrorInvalidValue;
  if (dense_kind(kind) ? Q != 1 || P.w4 : whole != 0)
    return (int)cudaErrorInvalidValue;
  if (whole && (H < 4 || H > 32 || (H & (H - 1))))   // v1's denominator pass
    return (int)cudaErrorInvalidValue;
  if (flags && (kind != CACHE_INT8 || P.w4)) return (int)cudaErrorInvalidValue;
  if (Dh != 16 && Dh != 48) return (int)cudaErrorInvalidValue;
  if (4 * d > 12 * 256) return (int)cudaErrorInvalidValue;   // ln_quant
  if (kind == CACHE_INT4 && (H % 2 || kv.c.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P.w4 && (d % 256 || 4 * d > 256 * W4_MAX_PAIRS))
    return (int)cudaErrorInvalidValue;
  Workspace w;
  workspace_layout(B, Q, d, H, S, (char*)workspace, &w);
  const int V = 15 * d;
  const int nthr = 256;
  // int8 products of few rows take their layer norm and quantization in
  // their own blocks: seven launches a layer at B = 1 with a prefix
  const bool fuse = !P.w4 && R <= LN_FUSE_ROWS;
  const Rows staged{w.aq, w.sa, nullptr, nullptr};
  init_h_kernel<<<(R * d + nthr - 1) / nthr, nthr, 0, st>>>(
      (const __nv_bfloat16*)x, w.h, R * d);
  for (int l = 0; l < L; ++l) {
    const float* vl = vec + (long long)l * V;
    Cache c = kv.c;
    c.k += l * kv.layer_stride;
    c.v += l * kv.layer_stride;
    if (kind == CACHE_INT4) {
      c.ks += l * kv.sc_layer_stride;
      c.vs += l * kv.sc_layer_stride;
    }
    const int8_t* wt[4];
    const float* sc[4];
    // int8: per-column scales qkv_ws, proj_ws, fc_ws, pj_ws of the vector
    // block; W4A8: the group scales
    const int vec_ws[4] = {2 * d, 8 * d, 10 * d, 14 * d};
    for (int i = 0; i < 4; ++i) {
      wt[i] = P.w[i] + l * P.w_stride[i];
      sc[i] = P.w4 ? P.s[i] + l * P.s_stride[i] : vl + vec_ws[i];
    }
    if (!fuse) ln_quant_kernel<<<R, nthr, 0, st>>>(w.h, vl, w.aq, w.sa, d);
    cudaError_t e = gemv(P.w4, fuse ? Rows{nullptr, nullptr, w.h, vl} : staged,
                         R, wt[0], sc[0], d, 3 * d, vl + 5 * d, EPI_STORE,
                         w.qkv, st);
    if (e != cudaSuccess) return (int)e;
    e = Dh == 48 ? attention_of_kind<48>(kind, w, B, Q, H, S, c, cl, bs,
                                         whole, scale, cq, flags, st)
                 : attention_of_kind<16>(kind, w, B, Q, H, S, c, cl, bs,
                                         whole, scale, cq, flags, st);
    if (e != cudaSuccess) return (int)e;
    e = gemv(P.w4, staged, R, wt[1], sc[1], d, d, vl + 9 * d, EPI_RESID, w.h,
             st);
    if (e != cudaSuccess) return (int)e;
    if (!fuse)
      ln_quant_kernel<<<R, nthr, 0, st>>>(w.h, vl + d, w.aq, w.sa, d);
    e = gemv(P.w4, fuse ? Rows{nullptr, nullptr, w.h, vl + d} : staged, R,
             wt[2], sc[2], d, 4 * d, nullptr, EPI_GELU, w.hid, st);
    if (e != cudaSuccess) return (int)e;
    if (!fuse)
      ln_quant_kernel<<<R, nthr, 0, st>>>(w.hid, nullptr, w.aq, w.sa, 4 * d);
    e = gemv(P.w4, fuse ? Rows{nullptr, nullptr, w.hid, nullptr} : staged, R,
             wt[3], sc[3], 4 * d, d, nullptr, EPI_RESID, w.h, st);
    if (e != cudaSuccess) return (int)e;
  }
  out_bf16_kernel<<<(R * d + nthr - 1) / nthr, nthr, 0, st>>>(
      w.h, (__nv_bfloat16*)out, R * d);
  return (int)cudaGetLastError();
}

// int8 weights (runtime/quantize.py pack_decode_weights): wqkv [L, 3d, d],
// wproj [L, d, d], wfc [L, 4d, d], wpj [L, d, 4d] int8, each stored
// output-major (input dim contiguous); their per-column scales sit in vec.
Products int8_products(int d, const void* wqkv, const void* wproj,
                       const void* wfc, const void* wpj) {
  const long long dd = (long long)d * d;
  return Products{false,
                  {(const int8_t*)wqkv, (const int8_t*)wproj,
                   (const int8_t*)wfc, (const int8_t*)wpj},
                  {3 * dd, dd, 4 * dd, 4 * dd},
                  {nullptr, nullptr, nullptr, nullptr},
                  {0, 0, 0, 0}};
}

// W4A8 weights (runtime/quantize.py w4_kernel_layout): w4k [L, 6d²] int8
// holds per layer the packed qkv [3d, d/2], proj [d, d/2], fc [4d, d/2] and
// pj [d, 2d] blocks, each output-major; s4k [L, 12·d·G] f32 (G = d/128)
// their group scales qkv [3d, G], proj [d, G], fc [4d, G], pj [d, 4G].
Products w4_products(int d, const void* w4k, const void* s4k) {
  const long long dd = (long long)d * d, G = d / 128;
  const int8_t* wb = (const int8_t*)w4k;
  const float* sb = (const float*)s4k;
  return Products{true,
                  {wb, wb + 3 * dd / 2, wb + 2 * dd, wb + 4 * dd},
                  {6 * dd, 6 * dd, 6 * dd, 6 * dd},
                  {sb, sb + 3 * d * G, sb + 4 * d * G, sb + 8 * d * G},
                  {12 * d * G, 12 * d * G, 12 * d * G, 12 * d * G}};
}

StepCache int8_cache(void* kc, void* vc, long long layer_stride,
                     long long batch_stride) {
  return StepCache{
      Cache{(int8_t*)kc, (int8_t*)vc, batch_stride, nullptr, nullptr, 0},
      layer_stride, 0};
}

StepCache int4_cache(void* kc, void* vc, long long layer_stride,
                     long long batch_stride, void* ks, void* vs,
                     long long sc_layer_stride, long long sc_batch_stride) {
  return StepCache{Cache{(int8_t*)kc, (int8_t*)vc, batch_stride, (float*)ks,
                         (float*)vs, sc_batch_stride},
                   layer_stride, sc_layer_stride};
}

}  // namespace

extern "C" const char* umgen_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" long long umgen_decode_workspace_bytes(int B, int Q, int d, int H,
                                                  int S) {
  Workspace w;
  return (long long)workspace_layout(B, Q, d, H, S, nullptr, &w);
}

// The int8 product of the steps by itself: out [R, N] float32 = the product
// of R rows and wt [N, K] int8 (output-major) with per-column scales ws [N]
// and bias [N] (or null), then epilogue epi (0 store, 1 GELU, 2 bf16
// residual into out).  The rows: x null — aq [R, K] int8 with scales sa [R];
// else x [R, K] float32, normalized with weight lnw (null: none) and
// quantized in each block (R <= 2).
extern "C" int umgen_gemv_i8(const void* aq, const void* sa, const void* x,
                             const void* lnw, int R, const void* wt, int K,
                             int N, const void* ws, const void* bias, int epi,
                             void* out, void* stream) {
  if (K % 16 || K > 3072 || (x != nullptr && R > 2) || epi < EPI_STORE ||
      epi > EPI_RESID)
    return (int)cudaErrorInvalidValue;
  return (int)gemv(false,
                   Rows{(const int8_t*)aq, (const float*)sa, (const float*)x,
                        (const float*)lnw},
                   R, (const int8_t*)wt, (const float*)ws, K, N,
                   (const float*)bias, epi, (float*)out, (cudaStream_t)stream);
}

// One decode step for x [B, Q, d] bf16 → out [B, Q, d] bf16 (before the
// final layer norm), int8 weights (int8_products) with vec [L, 15d] f32
// (ln1, ln2, qkv_ws, qkv_b, proj_ws, proj_b, fc_ws, pj_ws).  Caches kc/vc:
// int8 rows of d bytes; layer l, scene b, row s at l·layer_stride +
// b·batch_stride + s·d.  c16 = scale/16.  flags: STEP_HEAD_SCALE (TPU v7),
// STEP_ROWS_F32 (TPU v6); 0 is the v5 / v5mq step, which v3 and v4 are too on
// the flat view of their 5-D caches.  bs: rows of the prefix attention's
// S-blocks (the wrapper's `pick_block_s`; a softmax rescale a block is part
// of the result).
extern "C" int umgen_decode_step(const void* x, void* out, int B, int Q,
                                 int d, int H, int L, const void* vec,
                                 const void* wqkv, const void* wproj,
                                 const void* wfc, const void* wpj, void* kc,
                                 void* vc, long long layer_stride,
                                 long long batch_stride, int S, int cl,
                                 float scale, float c16, void* workspace,
                                 void* stream, int flags, int bs) {
  if (flags & ~(STEP_HEAD_SCALE | STEP_ROWS_F32))
    return (int)cudaErrorInvalidValue;
  return run_step(x, out, B, Q, d, H, L, (const float*)vec,
                  int8_products(d, wqkv, wproj, wfc, wpj),
                  int8_cache(kc, vc, layer_stride, batch_stride), S, cl,
                  scale, c16, workspace, (cudaStream_t)stream, flags,
                  CACHE_INT8, bs, 0);
}

// The int8-weight step on a dense cache (TPU v2; v1 with whole != 0): kc/vc
// rows of d values of type `code` (0 bf16, 1 fp8 e4m3, 2 int8 on the 1/16
// grid), read as bf16; layer l, scene b, row s at l·layer_stride +
// b·batch_stride + s·d·sizeof(type), strides in bytes.  bs: rows of an
// S-block (a bf16 rounding a block is part of the result); whole: one block
// over all of S with normalized weights.  One row a scene (Q = 1).
extern "C" int umgen_decode_step_dense(
    const void* x, void* out, int B, int Q, int d, int H, int L,
    const void* vec, const void* wqkv, const void* wproj, const void* wfc,
    const void* wpj, void* kc, void* vc, long long layer_stride,
    long long batch_stride, int S, int cl, float scale, int code, int bs,
    int whole, void* workspace, void* stream) {
  if (code < 0 || code > CACHE_GRID8 - CACHE_BF16)
    return (int)cudaErrorInvalidValue;
  return run_step(x, out, B, Q, d, H, L, (const float*)vec,
                  int8_products(d, wqkv, wproj, wfc, wpj),
                  int8_cache(kc, vc, layer_stride, batch_stride), S, cl,
                  scale, 0.f, workspace, (cudaStream_t)stream, 0,
                  CACHE_BF16 + code, whole ? S : bs, whole != 0);
}

// The same step with W4A8 weights (w4_products); vec as above, its ws
// slots unused; bs as above.
extern "C" int umgen_decode_step_w4(const void* x, void* out, int B, int Q,
                                    int d, int H, int L, const void* vec,
                                    const void* w4k, const void* s4k,
                                    void* kc, void* vc,
                                    long long layer_stride,
                                    long long batch_stride, int S, int cl,
                                    float scale, float c16, void* workspace,
                                    void* stream, int bs) {
  return run_step(x, out, B, Q, d, H, L, (const float*)vec,
                  w4_products(d, w4k, s4k),
                  int8_cache(kc, vc, layer_stride, batch_stride), S, cl,
                  scale, c16, workspace, (cudaStream_t)stream, 0,
                  CACHE_INT8, bs, 0);
}

// The int8-weight step on the int4 cache.  kc/vc: rows of d/2 nibble-pair
// bytes (halves layout), layer l, scene b, row s at l·layer_stride +
// b·batch_stride + s·d/2; ks/vs: float32 scales, H per row, at
// l·sc_layer_stride + b·sc_batch_stride + s·H (strides in floats).
// c7 = scale/7; bs as above.
extern "C" int umgen_decode_step_i4(
    const void* x, void* out, int B, int Q, int d, int H, int L,
    const void* vec, const void* wqkv, const void* wproj, const void* wfc,
    const void* wpj, void* kc, void* vc, long long layer_stride,
    long long batch_stride, void* ks, void* vs, long long sc_layer_stride,
    long long sc_batch_stride, int S, int cl, float scale, float c7,
    void* workspace, void* stream, int bs) {
  return run_step(x, out, B, Q, d, H, L, (const float*)vec,
                  int8_products(d, wqkv, wproj, wfc, wpj),
                  int4_cache(kc, vc, layer_stride, batch_stride, ks, vs,
                             sc_layer_stride, sc_batch_stride),
                  S, cl, scale, c7, workspace, (cudaStream_t)stream, 0,
                  CACHE_INT4, bs, 0);
}

// The W4A8 step on the int4 cache.
extern "C" int umgen_decode_step_w4_i4(
    const void* x, void* out, int B, int Q, int d, int H, int L,
    const void* vec, const void* w4k, const void* s4k, void* kc, void* vc,
    long long layer_stride, long long batch_stride, void* ks, void* vs,
    long long sc_layer_stride, long long sc_batch_stride, int S, int cl,
    float scale, float c7, void* workspace, void* stream, int bs) {
  return run_step(x, out, B, Q, d, H, L, (const float*)vec,
                  w4_products(d, w4k, s4k),
                  int4_cache(kc, vc, layer_stride, batch_stride, ks, vs,
                             sc_layer_stride, sc_batch_stride),
                  S, cl, scale, c7, workspace, (cudaStream_t)stream, 0,
                  CACHE_INT4, bs, 0);
}
