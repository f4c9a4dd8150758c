// Fused int8 OAR decode step: Q new rows per scene through all L layers.
//
// Replaces the TPU kernels `fused_decode_step_v5` (Q = 1) and
// `fused_decode_step_v5mq` / `_mq_call` (1 < Q <= 128/H) of
// umgen_tpu/ops/decode_kernel.py.  Per layer: LN1 → QKV → attention over the
// int8 KV prefix plus the chunk's own rows (causal within the chunk) → proj
// + residual → LN2 → fc → GELU (Abramowitz & Stegun erf) → proj + residual.
// Matmuls are W8A8: activations quantized per row (absmax/127), weights int8
// per output channel, int32 accumulation with __dp4a.  The residual stream
// rounds to bf16 after every add.  The chunk's K/V rows are written into the
// caches at `cache_len` on the fixed 1/16 int8 grid — in place (the JAX
// package writes the cache back functionally).
//
// What bounds it on the H100: a step reads every layer's int8 weights
// (7.1 MB/layer at d = 768, 255 MB for 36 layers) and the KV prefix (2 x
// 768 B per cached row per layer per scene, up to 122 MB at a full 2208-row
// cache); the arithmetic is ~2 ops/byte, so it is memory bound — 0.1-0.12
// ms at 3.35 TB/s.  The TPU kernel ran the 36 layers as one sequential grid
// with the hidden state carried in VMEM.  Hopper blocks carry nothing from
// one grid step to the next, so this version issues the layer sequence from
// the host (one C call per step, ten small kernels per layer on one
// stream): the hidden state lives in a global workspace between kernels,
// and the prefix attention is split over 32-row blocks of the cache whose
// partial (max, sum, weighted values) are merged by a second pass.  The
// design is simple and right first; it is launch-bound (~360 launches a
// step).  Graph capture or a persistent kernel, and wider weight streams,
// are the next steps for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS = 16;      // B * Q rows per step
constexpr int SPLIT_ROWS = 32;    // cache rows per split-attention block
constexpr int ATT_THREADS = 128;  // >= Q * H pairs (Q * H <= 128)

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int8_t quant_i8(float x, float s) {
  const float r = rintf(x / s);
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

// block-wide reductions over blockDim.x threads (a multiple of 32, <= 1024)
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

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

// per row: a = LN(h)·w (w null: a = h), then sa = max|a|/127 + 1e-12 and
// aq = clip(round(a / sa)); one block per row, the row staged in smem
__global__ void ln_quant_kernel(const float* __restrict__ h,
                                const float* __restrict__ w,
                                int8_t* __restrict__ aq,
                                float* __restrict__ sa, int n) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const float* x = h + (long long)blockIdx.x * n;
  float amax = 0.f;
  if (w != nullptr) {
    float s = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s += x[i];
    const float mu = block_sum(s, red) / (float)n;
    float s2 = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float c = x[i] - mu;
      s2 += c * c;
    }
    const float var = block_sum(s2, red) / (float)n;
    const float r = 1.f / sqrtf(var + 1e-5f);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float a = (x[i] - mu) * r * w[i];
      row[i] = a;
      amax = fmaxf(amax, fabsf(a));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      row[i] = x[i];
      amax = fmaxf(amax, fabsf(x[i]));
    }
  }
  const float s = block_max(amax, red) / 127.f + 1e-12f;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    aq[(long long)blockIdx.x * n + i] = quant_i8(row[i], s);
  if (threadIdx.x == 0) sa[blockIdx.x] = s;
}

enum Epilogue { EPI_STORE = 0, EPI_GELU = 1, EPI_RESID = 2 };

// y[r, n] = (Σ_k aq[r, k]·wt[n, k]) · sa[r] · ws[n] (+ b[n]) for all R rows;
// one warp per output column, lanes stride over K in 16-byte chunks (dp4a)
__global__ void gemv_i8_kernel(const int8_t* __restrict__ aq,
                               const float* __restrict__ sa, int R,
                               const int8_t* __restrict__ wt, int K, int N,
                               const float* __restrict__ ws,
                               const float* __restrict__ bias, int epi,
                               float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= N) return;
  int acc[MAX_ROWS];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0;
  const int nchunk = K / 16;
  const int4* wrow = reinterpret_cast<const int4*>(wt + (long long)n * K);
  for (int c = lane; c < nchunk; c += 32) {
    const int4 wv = __ldg(wrow + c);
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < R) {
        const int4 av =
            __ldg(reinterpret_cast<const int4*>(aq + (long long)r * K) + c);
        int a = acc[r];
        a = __dp4a(wv.x, av.x, a);
        a = __dp4a(wv.y, av.y, a);
        a = __dp4a(wv.z, av.z, a);
        a = __dp4a(wv.w, av.w, a);
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    if (r < R) {
      int a = acc[r];
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[r] = a;
    }
  }
  if (lane != 0) return;
  for (int r = 0; r < R; ++r) {
    float y = (float)acc[r] * sa[r] * ws[n];
    if (bias != nullptr) y = y + bias[n];
    float* dst = out + (long long)r * N + n;
    if (epi == EPI_GELU) {
      *dst = gelu_as(y);
    } else if (epi == EPI_RESID) {
      // residual in bf16: h = bf16(bf16(h) + bf16(y))
      *dst = bf16r(bf16r(*dst) + bf16r(y));
    } else {
      *dst = y;
    }
  }
}

// Per scene b (one block): store the chunk's K/V rows into the caches at
// cache_len (bf16-rounded, x16, round, clip), quantize the chunk's queries
// with one scale per scene, and fold the intra-chunk causal attention
// (query i over chunk keys j <= i) into the flash state (m0, den0, acc0).
__global__ void attn_prep_kernel(const float* __restrict__ qkv, int Q, int H,
                                 int Dh, int8_t* kc, int8_t* vc,
                                 long long batch_stride, int cl, float scale,
                                 float c16, int8_t* __restrict__ qp,
                                 float* __restrict__ factor,
                                 float* __restrict__ m0,
                                 float* __restrict__ den0,
                                 float* __restrict__ acc0) {
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int HD = H * Dh;
  const float* base = qkv + (long long)b * Q * 3 * HD;
  float amax = 0.f;
  for (int i = threadIdx.x; i < Q * HD; i += blockDim.x) {
    const int qi = i / HD, c = i % HD;
    const float* row = base + (long long)qi * 3 * HD;
    const long long dst = b * batch_stride + (long long)(cl + qi) * HD + c;
    kc[dst] = (int8_t)fminf(fmaxf(rintf(bf16r(row[HD + c]) * 16.f), -127.f),
                            127.f);
    vc[dst] =
        (int8_t)fminf(fmaxf(rintf(bf16r(row[2 * HD + c]) * 16.f), -127.f),
                      127.f);
    amax = fmaxf(amax, fabsf(row[c]));
  }
  const float sq = block_max(amax, red) / 127.f + 1e-12f;
  for (int i = threadIdx.x; i < Q * HD; i += blockDim.x) {
    const int qi = i / HD, c = i % HD;
    qp[(long long)b * Q * HD + i] = quant_i8(base[(long long)qi * 3 * HD + c],
                                             sq);
  }
  if (threadIdx.x == 0) factor[b] = sq * c16;
  for (int pr = threadIdx.x; pr < Q * H; pr += blockDim.x) {
    const int qi = pr / H, hh = pr % H;
    const float* qrow = base + (long long)qi * 3 * HD + hh * Dh;
    float lj[8];
    float mx = -CUDART_INF_F;
    for (int j = 0; j <= qi; ++j) {
      const float* krow = base + (long long)j * 3 * HD + HD + hh * Dh;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s += qrow[d] * krow[d];
      lj[j] = s * scale;
      mx = fmaxf(mx, lj[j]);
    }
    float den = 0.f;
    float* acc = acc0 + ((long long)b * Q + qi) * HD + hh * Dh;
    for (int d = 0; d < Dh; ++d) acc[d] = 0.f;
    for (int j = 0; j <= qi; ++j) {
      const float p = expf(lj[j] - mx);
      den += p;
      const float* vrow = base + (long long)j * 3 * HD + 2 * HD + hh * Dh;
      for (int d = 0; d < Dh; ++d) acc[d] += p * vrow[d];
    }
    m0[(long long)b * Q * H + pr] = mx;
    den0[(long long)b * Q * H + pr] = den;
  }
}

// Split attention over the int8 prefix: block (blk, b) takes cache rows
// [blk·32, min(cl, blk·32 + 32)); thread pr = (query, head) keeps an online
// softmax over those rows and writes its partial (max, sum, Σ p·v).
template <int DH>
__global__ void __launch_bounds__(ATT_THREADS)
attn_split_kernel(const int8_t* __restrict__ kc,
                  const int8_t* __restrict__ vc, long long batch_stride,
                  int cl, int Q, int H, const int8_t* __restrict__ qp,
                  const float* __restrict__ factor, int nblk,
                  float* __restrict__ pm, float* __restrict__ pl,
                  float* __restrict__ pacc) {
  const int blk = blockIdx.x, b = blockIdx.y;
  const int pr = threadIdx.x;
  if (pr >= Q * H) return;
  const int qi = pr / H, hh = pr % H;
  const int HD = H * DH;
  constexpr int W = DH / 16;        // int4 chunks per head
  int4 qv[W];
  const int4* qsrc =
      reinterpret_cast<const int4*>(qp + ((long long)b * Q + qi) * HD +
                                    hh * DH);
#pragma unroll
  for (int w = 0; w < W; ++w) qv[w] = qsrc[w];
  const float f = factor[b];
  float m = -CUDART_INF_F, l = 0.f, acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  const int s0 = blk * SPLIT_ROWS, s1 = min(cl, s0 + SPLIT_ROWS);
  for (int s = s0; s < s1; ++s) {
    const long long off = b * batch_stride + (long long)s * HD + hh * DH;
    const int4* krow = reinterpret_cast<const int4*>(kc + off);
    int li = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int4 kv = __ldg(krow + w);
      li = __dp4a(kv.x, qv[w].x, li);
      li = __dp4a(kv.y, qv[w].y, li);
      li = __dp4a(kv.z, qv[w].z, li);
      li = __dp4a(kv.w, qv[w].w, li);
    }
    const float logit = (float)li * f;
    const float mnew = fmaxf(m, logit);
    const float corr = expf(m - mnew);
    const float p = expf(logit - mnew);
    const float pb = bf16r(p);
    l = l * corr + p;
    const int4* vrow = reinterpret_cast<const int4*>(vc + off);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int4 vv = __ldg(vrow + w);
      const int8_t* ve = reinterpret_cast<const int8_t*>(&vv);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[w * 16 + j] = acc[w * 16 + j] * corr + pb * ((float)ve[j] * 0.0625f);
    }
    m = mnew;
  }
  const long long pidx = ((long long)b * nblk + blk) * Q * H + pr;
  pm[pidx] = m;
  pl[pidx] = l;
  float* dst = pacc + pidx * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) dst[d] = acc[d];
}

// Merge the intra-chunk state with the prefix partials, y = acc / den, then
// quantize each of the scene's Q rows for the output projection.
template <int DH>
__global__ void __launch_bounds__(ATT_THREADS)
attn_combine_kernel(int Q, int H, int nblk, const float* __restrict__ m0,
                    const float* __restrict__ den0,
                    const float* __restrict__ acc0,
                    const float* __restrict__ pm,
                    const float* __restrict__ pl,
                    const float* __restrict__ pacc, int8_t* __restrict__ yq,
                    float* __restrict__ sa) {
  extern __shared__ float ys[];   // [Q][HD]
  __shared__ float rmax[8];
  const int b = blockIdx.x;
  const int HD = H * DH;
  const int pr = threadIdx.x;
  if (pr < Q * H) {
    const int qi = pr / H, hh = pr % H;
    const long long i0 = (long long)b * Q * H + pr;
    float m = m0[i0], l = den0[i0], acc[DH];
    const float* a0 = acc0 + ((long long)b * Q + qi) * HD + hh * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] = a0[d];
    for (int blk = 0; blk < nblk; ++blk) {
      const long long pidx = ((long long)b * nblk + blk) * Q * H + pr;
      const float mb = pm[pidx];
      const float mnew = fmaxf(m, mb);
      const float c1 = expf(m - mnew), c2 = expf(mb - mnew);
      l = l * c1 + pl[pidx] * c2;
      const float* ab = pacc + pidx * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = acc[d] * c1 + ab[d] * c2;
      m = mnew;
    }
#pragma unroll
    for (int d = 0; d < DH; ++d) ys[qi * HD + hh * DH + d] = acc[d] / l;
  }
  __syncthreads();
  if (pr < Q) {
    float amax = 0.f;
    for (int c = 0; c < HD; ++c) amax = fmaxf(amax, fabsf(ys[pr * HD + c]));
    rmax[pr] = amax / 127.f + 1e-12f;
    sa[b * Q + pr] = rmax[pr];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q * HD; i += blockDim.x)
    yq[(long long)b * Q * HD + i] = quant_i8(ys[i], rmax[i / HD]);
}

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

struct Workspace {
  float* h;       // [R, d] residual stream (bf16 values in float32)
  int8_t* aq;     // [R, 4d] quantized activations
  float* sa;      // [R] activation scales
  float* qkv;     // [R, 3d]
  int8_t* qp;     // [B, Q, d] quantized queries
  float* factor;  // [B]
  float* m0;      // [B, Q*H]
  float* den0;    // [B, Q*H]
  float* acc0;    // [B, Q, d]
  float* pm;      // [B, nblk, Q*H]
  float* pl;      // [B, nblk, Q*H]
  float* pacc;    // [B, nblk, Q, d]
  float* hid;     // [R, 4d]
};

size_t workspace_layout(int B, int Q, int d, int H, int S, char* base,
                        Workspace* ws) {
  const size_t R = (size_t)B * Q;
  const size_t nblk = (S + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const size_t sizes[13] = {
      R * d * 4,        R * 4 * d,        R * 4,
      R * 3 * d * 4,    R * d,            (size_t)B * 4,
      R * H * 4,        R * H * 4,        R * d * 4,
      B * nblk * Q * H * 4, B * nblk * Q * H * 4, B * nblk * Q * d * 4,
      R * 4 * d * 4};
  void** slots[13] = {(void**)&ws->h,    (void**)&ws->aq,   (void**)&ws->sa,
                      (void**)&ws->qkv,  (void**)&ws->qp,   (void**)&ws->factor,
                      (void**)&ws->m0,   (void**)&ws->den0, (void**)&ws->acc0,
                      (void**)&ws->pm,   (void**)&ws->pl,   (void**)&ws->pacc,
                      (void**)&ws->hid};
  size_t off = 0;
  for (int i = 0; i < 13; ++i) {
    if (base != nullptr) *slots[i] = base + off;
    off += align_up(sizes[i]);
  }
  return off;
}

template <int DH>
cudaError_t attention(const Workspace& w, int B, int Q, int H, int8_t* kc,
                      int8_t* vc, long long batch_stride, int cl,
                      float scale, float c16, cudaStream_t st) {
  attn_prep_kernel<<<B, 256, 0, st>>>(w.qkv, Q, H, DH, kc, vc, batch_stride,
                                      cl, scale, c16, w.qp, w.factor, w.m0,
                                      w.den0, w.acc0);
  const int nblk = (cl + SPLIT_ROWS - 1) / SPLIT_ROWS;
  if (nblk > 0)
    attn_split_kernel<DH><<<dim3(nblk, B), ATT_THREADS, 0, st>>>(
        kc, vc, batch_stride, cl, Q, H, w.qp, w.factor, nblk, w.pm, w.pl,
        w.pacc);
  const size_t smem = (size_t)Q * H * DH * sizeof(float);
  attn_combine_kernel<DH><<<B, ATT_THREADS, smem, st>>>(
      Q, H, nblk, w.m0, w.den0, w.acc0, w.pm, w.pl, w.pacc, w.aq, w.sa);
  return cudaGetLastError();
}

void gemv(const Workspace& w, int R, const int8_t* wt, int K, int N,
          const float* ws, const float* bias, int epi, float* out,
          cudaStream_t st) {
  constexpr int WARPS = 8;
  gemv_i8_kernel<<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
      w.aq, w.sa, R, wt, K, N, ws, bias, epi, out);
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

// One decode step for x [B, Q, d] bf16 → out [B, Q, d] bf16 (before the
// final layer norm).  Packed per-layer weights (runtime/quantize.py
// pack_decode_weights): vec [L, 15d] f32 (ln1, ln2, qkv_ws, qkv_b, proj_ws,
// proj_b, fc_ws, pj_ws), wqkv [L, 3d, d], wproj [L, d, d], wfc [L, 4d, d],
// wpj [L, d, 4d] int8, each stored output-major (input dim contiguous).
// Caches kc/vc: int8 rows of d bytes; layer l, scene b, row s at
// l·layer_stride + b·batch_stride + s·d.
extern "C" int umgen_decode_step(const void* x, void* out, int B, int Q,
                                 int d, int H, int L, const void* vec,
                                 const void* wqkv, const void* wproj,
                                 const void* wfc, const void* wpj, void* kc,
                                 void* vc, long long layer_stride,
                                 long long batch_stride, int S, int cl,
                                 float scale, float c16, void* workspace,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int R = B * Q, Dh = d / H;
  if (R > MAX_ROWS || Q > 8 || Q * H > ATT_THREADS || cl + Q > S)
    return (int)cudaErrorInvalidValue;
  if (Dh != 16 && Dh != 48) return (int)cudaErrorInvalidValue;
  Workspace w;
  workspace_layout(B, Q, d, H, S, (char*)workspace, &w);
  const int V = 15 * d;
  const int nthr = 256;
  init_h_kernel<<<(R * d + nthr - 1) / nthr, nthr, 0, st>>>(
      (const __nv_bfloat16*)x, w.h, R * d);
  for (int l = 0; l < L; ++l) {
    const float* vl = (const float*)vec + (long long)l * V;
    int8_t* kl = (int8_t*)kc + l * layer_stride;
    int8_t* vlc = (int8_t*)vc + l * layer_stride;
    const int8_t* wq = (const int8_t*)wqkv + (long long)l * 3 * d * d;
    const int8_t* wp = (const int8_t*)wproj + (long long)l * d * d;
    const int8_t* wf = (const int8_t*)wfc + (long long)l * 4 * d * d;
    const int8_t* wj = (const int8_t*)wpj + (long long)l * 4 * d * d;
    ln_quant_kernel<<<R, nthr, d * sizeof(float), st>>>(w.h, vl, w.aq, w.sa,
                                                        d);
    gemv(w, R, wq, d, 3 * d, vl + 2 * d, vl + 5 * d, EPI_STORE, w.qkv, st);
    cudaError_t e = Dh == 48 ? attention<48>(w, B, Q, H, kl, vlc,
                                             batch_stride, cl, scale, c16, st)
                             : attention<16>(w, B, Q, H, kl, vlc,
                                             batch_stride, cl, scale, c16, st);
    if (e != cudaSuccess) return (int)e;
    gemv(w, R, wp, d, d, vl + 8 * d, vl + 9 * d, EPI_RESID, w.h, st);
    ln_quant_kernel<<<R, nthr, d * sizeof(float), st>>>(w.h, vl + d, w.aq,
                                                        w.sa, d);
    gemv(w, R, wf, d, 4 * d, vl + 10 * d, nullptr, EPI_GELU, w.hid, st);
    ln_quant_kernel<<<R, nthr, 4 * d * sizeof(float), st>>>(
        w.hid, nullptr, w.aq, w.sa, 4 * d);
    gemv(w, R, wj, 4 * d, d, vl + 14 * d, nullptr, EPI_RESID, w.h, st);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  out_bf16_kernel<<<(R * d + nthr - 1) / nthr, nthr, 0, st>>>(
      w.h, (__nv_bfloat16*)out, R * d);
  return (int)cudaGetLastError();
}
