// Flash attention for head_dim 48, bf16 in / bf16 out, float32 logits.
//
// Replaces the TPU kernel `flash_attention` (umgen_tpu/ops/flash_attention.py,
// `_attn_kernel_t`): softmax(q·kᵀ/√Dh)·v over [B, S, H, Dh] tensors, with an
// optional bottom-right-aligned causal mask (query i sees keys
// j <= i + Sk - Sq); a row with nothing to attend comes out as 0.
//
// What bounds it on the H100: at the rollout's spatial shapes (Sq = Sk =
// 1031..2207, Dh = 48) the work is 4·Sq·Sk·Dh FLOPs per (batch, head) over
// only (Sq + 2·Sk)·Dh·2 bytes of input, so it is bound by operations (~2000
// FLOP/byte).  At Dh = 48 the tensor-core work of a 64 x 64 tile (two products
// of 64·64·48) is small beside its softmax (64·64 exponentials, a max and a
// sum), so the multi-function unit and the float32 pipes weigh as much as the
// tensor cores.  The TPU kernel held one (batch, head)'s whole K/V in VMEM
// and did a one-shot softmax; a Hopper block has 227 KB of shared memory, so
// this kernel streams K/V tiles and keeps an online softmax.
//
// Design (Hopper, sm_90a): a block takes 64 queries of one (batch, head)
// and holds one consumer warpgroup and one producer warp: 160 threads and 98
// registers a thread let several blocks share an SM, which hides one block's
// softmax behind another's products (two consumer warpgroups a block, 128
// queries, ran slower at the rollout's shapes).
//   * The producer warp streams the 64-key K and V tiles with TMA
//     (cp.async.bulk.tensor, tensor maps encoded on the host) into a ring of
//     STAGES stages in shared memory; `full` mbarriers carry the bytes' arrival,
//     `empty` ones the consumers' release, so loads stay in flight while the
//     consumers compute.
//   * A consumer warpgroup owns 64 query rows.  Its Q stays in registers as
//     wgmma A fragments.  S = Q·Kᵀ is three wgmma m64n64k16 (k over Dh = 48);
//     P turns into bf16 A fragments in registers, and O += P·V is four wgmma
//     m64n48k16 with V read as an MN-major B operand: no transpose anywhere.
//     The accumulators stay in registers.
//   * Dh = 48 is not a swizzle-atom width (96 bytes a row).  A tile is a TMA
//     box of 64 elements x 64 rows with 128-byte swizzle, the canonical
//     layout wgmma reads without bank conflicts: the 16 columns past the head
//     (the next head's, or the tensor map's zero fill after the last head)
//     land in shared memory, but exactly three k-steps of S and N = 48 of the
//     value product never read them.  This keeps one swizzle atom a row and a
//     descriptor step of 32 bytes a k-step; three 32-byte-swizzled boxes a
//     tile would triple the TMA issue count for the same bytes.
//   * The softmax works in base 2: log2(e)/√Dh is folded into one multiply-
//     add per logit (exp2 of s·c − m·c).  The mask is applied only on the
//     ragged last key tile and on the causal diagonal tiles.
//   * Built without --fmad=false (see ops/_cuda.py): no plain version can
//     follow the tensor cores' rounding, so contractions cost nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int DH = 48;
constexpr int BK = 64;                        // keys a tile
constexpr int BOX_COLS = 64;                  // elements a tile row (128 B)
constexpr int TILE_BYTES = BK * BOX_COLS * 2; // 8 KB: one K or V tile
constexpr int STAGES = 4;
constexpr int NWG = 1;                        // consumer warpgroups a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of `bar` with this parity has completed; a wait of
// more than ~2^34 clocks (seconds) traps, so a lost transfer is a launch
// error and not a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-D tensor map (element column, row, batch) into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D[64 x 64] (+)= A[64 x 16] (registers, bf16) · B[16 x 64] (shared memory)
template <int TNSP_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TNSP_B));
}

// D[64 x 48] (+)= A[64 x 16] (registers, bf16) · B[16 x 48] (shared memory)
template <int TNSP_B>
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TNSP_B));
}

// keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous products (their registers belong to the tensor cores
// between the issue and the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

struct FlashArgs {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  long long q_sb, q_ss;   // q's batch and row strides (elements)
  int H, Sq, Sk, causal;
  float c;                // log2(e) / √Dh
};

__global__ void __launch_bounds__(NWG * 128 + 32)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const FlashArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // the ring, 1024-byte aligned (the 128-byte swizzle atom), then barriers
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 2 * TILE_BYTES);
  uint64_t* empty = full + STAGES;

  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * 64 * NWG;
  const int shift = a.Sk - a.Sq;               // bottom-right causal alignment
  const int kend = a.causal ? min(a.Sk, min(q0 + 64 * NWG, a.Sq) + shift)
                            : a.Sk;
  const int ntiles = kend > 0 ? (kend + BK - 1) / BK : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);          // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {                       // the producer warp
    if (lane == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        uint8_t* kt = ring + s * 2 * TILE_BYTES;
        tma_load_3d(kt, &kmap, &full[s], h * DH, j * BK, b);
        tma_load_3d(kt + TILE_BYTES, &vmap, &full[s], h * DH, j * BK, b);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows, 16 a warp, two a thread
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = q0 + wg * 64;
  const int r0 = rbase + wl * 16 + g, r1 = r0 + 8;
  const bool active = rbase < a.Sq;
  // keys [0, wg_kend) are seen by some row of this warpgroup
  const int wg_kend =
      a.causal ? min(a.Sk, min(rbase + 64, a.Sq) + shift) : a.Sk;
  const int qp0 = r0 + shift, qp1 = r1 + shift;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + h * DH;
  uint32_t qa[3][4];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < a.Sq ? *(const uint32_t*)(qb + r0 * a.q_ss + c) : 0u;
    qa[kk][1] = r1 < a.Sq ? *(const uint32_t*)(qb + r1 * a.q_ss + c) : 0u;
    qa[kk][2] = r0 < a.Sq ? *(const uint32_t*)(qb + r0 * a.q_ss + c + 8) : 0u;
    qa[kk][3] = r1 < a.Sq ? *(const uint32_t*)(qb + r1 * a.q_ss + c + 8) : 0u;
  }

  float o[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max of s·c
  float l[2] = {0.f, 0.f};                       // this thread's partial sums

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const int k0 = j * BK;
    mbar_wait(&full[s], (j / STAGES) & 1);
    if (active && k0 < wg_kend) {
      const uint32_t kaddr = smem_u32(ring + s * 2 * TILE_BYTES);
      const uint32_t vaddr = kaddr + TILE_BYTES;
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)     // K-major B: a k-step is 32 bytes
        wgmma_m64n64k16<0>(sc, qa[kk], sw128_desc(kaddr + kk * 32, 16, 1024),
                           kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // the mask: the ragged last tile and the causal diagonal only
      if (k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > rbase + shift)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (col >= a.Sk || (a.causal && col > qp)) sc[i] = -CUDART_INF_F;
        }
      }
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float ms[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[r], quad_max(mx[r]) * a.c);
        ms[r] = mnew == -CUDART_INF_F ? 0.f : mnew;   // all masked so far
        corr[r] = ex2(m[r] - ms[r]);
        m[r] = mnew;
      }
      uint32_t pa[4][4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        const float p0 = ex2(fmaf(sc[4 * n8 + 0], a.c, -ms[0]));
        const float p1 = ex2(fmaf(sc[4 * n8 + 1], a.c, -ms[0]));
        const float p2 = ex2(fmaf(sc[4 * n8 + 2], a.c, -ms[1]));
        const float p3 = ex2(fmaf(sc[4 * n8 + 3], a.c, -ms[1]));
        ps[0] += p0 + p1;
        ps[1] += p2 + p3;
        // the accumulator layout of keys 8·n8.. is the A fragment's half
        pa[n8 >> 1][(n8 & 1) * 2 + 0] = pack_bf16(p0, p1);
        pa[n8 >> 1][(n8 & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[0] = l[0] * corr[0] + ps[0];
      l[1] = l[1] * corr[1] + ps[1];
#pragma unroll
      for (int i = 0; i < 24; ++i) o[i] *= corr[(i >> 1) & 1];

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)     // MN-major V: 16 keys are 2048 bytes
        wgmma_m64n48k16<1>(o, pa[kk],
                           sw128_desc(vaddr + kk * 2048, 1024, 1024), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (!active) return;

  const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const long long rs = (long long)a.H * DH;     // output row stride
  __nv_bfloat16* ob = a.o + ((long long)b * a.Sq * a.H + h) * DH;
#pragma unroll
  for (int n8 = 0; n8 < 6; ++n8) {
    const int c = n8 * 8 + 2 * t;
    if (r0 < a.Sq)
      *(uint32_t*)(ob + r0 * rs + c) =
          pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
    if (r1 < a.Sq)
      *(uint32_t*)(ob + r1 * rs + c) =
          pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library links no libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the tensor map of a [B, S, H·Dh] view (row stride ss, batch stride sb, in
// elements): boxes of 64 columns x 64 rows of one scene, 128-byte swizzle,
// zeros past the edges
bool encode_kv_map(CUtensorMap* map, const void* base, int B, int S, int H,
                   long long sb, long long ss) {
  const cuuint64_t dims[3] = {(cuuint64_t)H * DH, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[3] = {BOX_COLS, BK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v: [B, S, H, 48] bf16 views (batch and row strides in elements, heads
// 48 apart, dims contiguous, 16-byte aligned); o: [B, Sq, H, 48] contiguous.
extern "C" int umgen_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Sq, int Sk, int causal, float scale,
                                     long long q_sb, long long q_ss,
                                     long long k_sb, long long k_ss,
                                     long long v_sb, long long v_ss,
                                     void* stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  if (Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  if (!encode_kv_map(&km, k, B, Sk, H, k_sb, k_ss) ||
      !encode_kv_map(&vm, v, B, Sk, H, v_sb, v_ss))
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{(const __nv_bfloat16*)q, (__nv_bfloat16*)o, q_sb, q_ss,
                    H, Sq, Sk, causal,
                    scale * 1.4426950408889634f};
  const size_t smem = 1024 + STAGES * 2 * TILE_BYTES + 2 * STAGES * 8;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + 64 * NWG - 1) / (64 * NWG), B * H);
  flash_attn_wgmma_kernel<<<grid, NWG * 128 + 32, smem,
                            (cudaStream_t)stream>>>(km, vm, a);
  return (int)cudaGetLastError();
}
