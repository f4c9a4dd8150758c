// Flash attention for head_dim 48, bf16 in / bf16 out, float32 logits.
//
// Replaces the TPU kernel `flash_attention` (umgen_tpu/ops/flash_attention.py,
// `_attn_kernel_t`): softmax(q·kᵀ/√Dh)·v over [B, S, H, Dh] tensors, with an
// optional bottom-right-aligned causal mask (query i sees keys
// j <= i + Sk - Sq); a row with nothing to attend comes out as 0.
//
// What bounds it on the H100: at the rollout's spatial shapes (Sq = Sk =
// 1031..2207, Dh = 48) the work is 4·Sq·Sk·Dh FLOPs per (batch, head) over
// only (Sq + 2·Sk)·Dh·2 bytes of input, so it is compute bound (~2000
// FLOP/byte).  The TPU kernel held one (batch, head)'s whole K/V in VMEM and
// did a one-shot softmax; a Hopper block has 227 KB of shared memory and the
// logits of one query block against 2207 keys would not fit in registers,
// so this kernel streams K/V tiles and keeps an online softmax instead.
//
// Design: one block of 4 warps per (64 queries, batch·head).  Each warp owns
// 16 query rows; Q stays in registers as mma.sync A fragments (48 = 3 k-steps
// of 16).  Per 64-key tile the block stages K (row-major) and V (transposed)
// in shared memory, each warp computes S = Q·Kᵀ with 24
// mma.sync.m16n8k16 bf16 products, rescales its running max / sum, turns P
// into bf16 A fragments in registers and accumulates O += P·V with another
// 24 products.  Simple first: no cp.async/TMA double buffering, no wgmma —
// those are the next steps for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int DH = 48;
constexpr int BQ = 64;          // queries per block (4 warps x 16 rows)
constexpr int BK = 64;          // keys per tile
constexpr int KSTR = DH + 8;    // K tile row stride (bf16): conflict-free reads
constexpr int VSTR = BK + 8;    // transposed V tile row stride (bf16)
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o,
                  int H, int Sq, int Sk, int causal, float scale,
                  long long q_sb, long long q_ss, long long k_sb,
                  long long k_ss, long long v_sb, long long v_ss) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK * KSTR];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * VSTR];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // q/k/v may be strided views (e.g. slices of a fused qkv projection):
  // batch and row strides are given, heads are DH apart, dims contiguous
  const __nv_bfloat16* qb = q + b * q_sb + h * DH;
  const __nv_bfloat16* kb = k + b * k_sb + h * DH;
  const __nv_bfloat16* vb = v + b * v_sb + h * DH;
  const long long rs = (long long)H * DH;           // output row stride
  __nv_bfloat16* ob = o + ((long long)b * Sq * H + h) * DH;

  const int r0 = q0 + warp * 16 + g;   // this thread's two query rows
  const int r1 = r0 + 8;
  uint32_t qa[3][4];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < Sq ? *(const uint32_t*)(qb + r0 * q_ss + c) : 0u;
    qa[kk][1] = r1 < Sq ? *(const uint32_t*)(qb + r1 * q_ss + c) : 0u;
    qa[kk][2] = r0 < Sq ? *(const uint32_t*)(qb + r0 * q_ss + c + 8) : 0u;
    qa[kk][3] = r1 < Sq ? *(const uint32_t*)(qb + r1 * q_ss + c + 8) : 0u;
  }
  const int shift = Sk - Sq;           // bottom-right causal alignment
  const int qp0 = r0 + shift, qp1 = r1 + shift;

  float oacc[6][4];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};             // per-thread partial row sums

  int kend = Sk;
  if (causal) kend = min(Sk, min(q0 + BQ, Sq) + shift);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (DH / 8); i += THREADS) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        kv = *(const uint4*)(kb + (k0 + r) * k_ss + c);
        vv = *(const uint4*)(vb + (k0 + r) * v_ss + c);
      }
      *(uint4*)(ks + r * KSTR + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * VSTR + r] = ve[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        const __nv_bfloat16* kp = ks + (nt * 8 + g) * KSTR + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa[kk], *(const uint32_t*)kp,
                 *(const uint32_t*)(kp + 8));
      }
    }

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int qp = (e >> 1) ? qp1 : qp0;
        const bool ok = col < Sk && (!causal || col <= qp);
        const float x = ok ? s[nt][e] * scale : -CUDART_INF_F;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float ms[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mnew = fmaxf(m[i], row_max4(mx[i]));
      ms[i] = mnew == -CUDART_INF_F ? 0.f : mnew;   // all masked so far
      corr[i] = expf(m[i] - ms[i]);
      m[i] = mnew;
    }

    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = expf(s[nt][0] - ms[0]), p1 = expf(s[nt][1] - ms[0]);
      const float p2 = expf(s[nt][2] - ms[1]), p3 = expf(s[nt][3] - ms[1]);
      l[0] = (nt == 0 ? l[0] * corr[0] : l[0]) + p0 + p1;
      l[1] = (nt == 0 ? l[1] * corr[1] : l[1]) + p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dt = 0; dt < 6; ++dt) {
      oacc[dt][0] *= corr[0];
      oacc[dt][1] *= corr[0];
      oacc[dt][2] *= corr[1];
      oacc[dt][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dt = 0; dt < 6; ++dt) {
        const __nv_bfloat16* vp = vt + (dt * 8 + g) * VSTR + kk * 16 + 2 * t;
        mma_bf16(oacc[dt], pa[kk], *(const uint32_t*)vp,
                 *(const uint32_t*)(vp + 8));
      }
    }
  }

  const float l0 = row_sum4(l[0]), l1 = row_sum4(l[1]);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int dt = 0; dt < 6; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (r0 < Sq)
      *(uint32_t*)(ob + r0 * rs + c) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (r1 < Sq)
      *(uint32_t*)(ob + r1 * rs + c) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int umgen_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Sq, int Sk, int causal, float scale,
                                     long long q_sb, long long q_ss,
                                     long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss,
                                     void* stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, H, Sq, Sk, causal, scale,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss);
  return (int)cudaGetLastError();
}
