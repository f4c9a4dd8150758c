// The exact-erf GELU in bf16, fp16 or float32, bit for bit the plain
// version in each.
//
// Replaces no TPU kernel: the JAX package's `jax.nn.gelu(approximate=False)`
// is an XLA fusion, which computes erfc in float32 in one pass.  The port's
// plain version (umgen_tpu_torch/models/modules.py `_gelu_plain`,
// `_erfc_f32`) repeats XLA's float32 erfc in eager PyTorch: three rational
// branches each evaluated in full and picked by torch.where, 75 device
// passes over the activation and about 688 bytes moved an element.  This
// kernel is one pass: y = r(r(0.5·x) · r(erfc(-x·c))), r the rounding to
// x's dtype and back (none in float32), c = √½ in x's dtype (0.70703125 in
// bf16 and fp16), with erfc from the branch the plain version keeps
// (|z| < 1: a polynomial in z²; [1, 2) and >= 2: exp(-z²)/|z| times a
// polynomial in 1/z², 0 past -z² < -88.7228394, reflected as 2 - erfc for
// z < 0).  Each step rounds where the plain version's eager op does: every
// multiply and add to float32 (the Horner steps separately), 1/z² and 1/|z|
// correctly rounded (torch.reciprocal's IEEE divide), exp as expf (what
// PyTorch's CUDA exp calls), erfc and 0.5·x to x's dtype and back, the
// product to x's dtype, all round to nearest even, subnormals kept.  Built
// with --fmad=false (ops/_cuda.py) and written with the _rn intrinsics
// besides, so that no multiply and add contract into one rounding.
//
// What bounds it on the H100: 2 bytes read and 2 written an element in
// bf16 (the main path), 4 B against 3.35 TB/s (0.081 ms at [22070, 3072]);
// 8 B in float32.  The arithmetic is 18 float32 operations an element on
// the |z| < 1 branch and 25-27 on the others (two IEEE reciprocals and an
// expf among them), under the memory time at the issue rate; but a warp
// whose lanes take both branches issues both, and a reciprocal or an expf
// is several instructions, so the kernel issues a few tens of instructions
// an element, near the memory time.
//
// Design: 16-byte vector loads and stores (8 bf16 or fp16, 4 float32) a
// thread an iteration (the input read once, evict-first), a grid of a few
// blocks an SM from the SM count with a grid-stride loop, so that every SM
// keeps enough loads in flight to cover the branches' latency; int64
// indices; a scalar tail for the elements past the last whole vector.  The
// branch is taken per element (only the kept one is computed), not
// evaluated three times and selected.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

// modules._ERFC_SMALL, _ERFC_MID, _ERFC_LARGE
__constant__ float SMALL[7] = {7.85386146e-05f, -0.000801019371f,
                               0.00518832775f,  -0.0268538129f,
                               0.112835854f,    -0.37612626f,
                               1.12837911f};
__constant__ float MID[9] = {0.0232682f,    -0.138703942f, 0.368742466f,
                             -0.582473278f, 0.621000469f,  -0.494451523f,
                             0.340488f,     -0.274112701f, 0.563825965f};
__constant__ float LARGE[8] = {-10.477664f,   12.9772f,     -7.49551868f,
                               2.92101908f,   -1.01526523f, 0.42184633f,
                               -0.282076746f, 0.564189494f};

// x's dtype: widening to float32, rounding to it (nearest even), and √½ as
// `float(torch.tensor(math.sqrt(0.5), dtype=dt))` gives it
template <typename T> struct Dt;
template <> struct Dt<__nv_bfloat16> {
  static constexpr float C = 0.70703125f;
  __device__ static float wide(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Dt<__half> {
  static constexpr float C = 0.70703125f;
  __device__ static float wide(__half v) { return __half2float(v); }
  __device__ static __half narrow(float v) { return __float2half_rn(v); }
};
template <> struct Dt<float> {
  static constexpr float C = 0.707106769f;
  __device__ static float wide(float v) { return v; }
  __device__ static float narrow(float v) { return v; }
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Dt<T>::wide(Dt<T>::narrow(x));
}

// y = t·c0 + c1, then y = y·t + c for the rest: modules._horner
template <int N>
__device__ __forceinline__ float horner(float t, const float (&c)[N]) {
  float y = __fadd_rn(__fmul_rn(t, c[0]), c[1]);
#pragma unroll
  for (int i = 2; i < N; ++i) y = __fadd_rn(__fmul_rn(y, t), c[i]);
  return y;
}

// erfc(z) in float32 as modules._erfc_f32 gives it, the branch its
// torch.where keeps
__device__ __forceinline__ float erfc_f32(float z) {
  const float az = fabsf(z);
  const float zz = __fmul_rn(z, z);
  if (az < 1.f) return __fsub_rn(1.f, __fmul_rn(z, horner(zz, SMALL)));
  const float q = __frcp_rn(zz);
  const float poly = az < 2.f ? horner(q, MID) : horner(q, LARGE);
  float tail = __fmul_rn(__fmul_rn(expf(-zz), __frcp_rn(az)), poly);
  if (-zz < -88.7228394f) tail = 0.f;
  return z < 0.f ? __fsub_rn(2.f, tail) : tail;
}

// one element
template <typename T>
__device__ __forceinline__ T gelu(T v) {
  const float x = Dt<T>::wide(v);
  const float e = round_to<T>(erfc_f32(__fmul_rn(-x, Dt<T>::C)));
  const float half = round_to<T>(__fmul_rn(0.5f, x));
  return Dt<T>::narrow(__fmul_rn(half, e));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gelu_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
            long long nvec, const T* __restrict__ xt, T* __restrict__ yt,
            int ntail) {
  constexpr int VEC = sizeof(uint4) / sizeof(T);
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * THREADS;
  for (long long i = first; i < nvec; i += step) {
    uint4 v = __ldcs(x + i);
    T* p = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = gelu(p[j]);
    y[i] = v;
  }
  if (first < ntail) yt[first] = gelu(xt[first]);
}

template <typename T>
int launch(const void* x, void* y, long long n, cudaStream_t stream) {
  constexpr int VEC = sizeof(uint4) / sizeof(T);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long nvec = n / VEC;
  const int ntail = (int)(n % VEC);
  const long long want = (nvec + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int blocks = (int)(want < 1 ? 1 : want < cap ? want : cap);
  gelu_kernel<T><<<blocks, THREADS, 0, stream>>>(
      (const uint4*)x, (uint4*)y, nvec, (const T*)x + nvec * VEC,
      (T*)y + nvec * VEC, ntail);
  return (int)cudaGetLastError();
}

}  // namespace

// y = gelu(x) over n contiguous elements of dtype 0 bf16, 1 fp16,
// 2 float32; x and y 16-byte aligned
extern "C" int umgen_gelu(const void* x, void* y, long long n, int dtype,
                          void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(x, y, n, s);
    case 1: return launch<__half>(x, y, n, s);
    case 2: return launch<float>(x, y, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
