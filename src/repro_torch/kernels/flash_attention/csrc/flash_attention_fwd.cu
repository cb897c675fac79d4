// Flash attention forward for Hopper: blocked online-softmax attention
// o = softmax(mask(softcap(q k^T / sqrt(D)))) v on (BH, S, D) tensors.
//
// Replaces the Pallas TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel), and
// keeps its semantics: absolute positions qp = row and kp = col (no offset
// when Sq != Sk), masked scores at -1e30, exponentials relative to the
// running max, m, l and acc in f32, p rounded to the input type before the
// p @ v product (the reference casts p to v's dtype), one division
// acc / max(l, 1e-30) at the end, output in the input type.
//
// Bound on the H100 SXM (data-sheet peaks, at its 700 W power limit): at
// TinyLlama-1.1B prefill (batch 8, S = 1024, 256 heads of D = 64, bf16,
// causal) q, k, v and o (k and v repeated to 32 heads) move about
// 0.134 GB: 0.040 ms at 3.35 TB/s.  The causal score and p @ v work is
// about 34 GFLOP: 0.035 ms at the 989 TFLOP/s bf16 tensor-core peak.
// The bound is the larger, 0.040 ms, by bytes, and the two are close, so
// a fast kernel must both stream q, k, v once and keep the tensor cores
// busy.
//
// This first design is simple and right rather than fast.  One block of
// 256 threads takes one (bh, 64-row q tile): it stages q once in shared
// memory as f32, then walks the 64-key tiles of k and v (the TPU grid's
// sequential kv axis becomes this loop), staging each in shared memory.
// Products run on the CUDA cores in f32: thread (ty, tx) of the 16 x 16
// grid owns rows ty + 16 i (i < 4), and score columns tx + 16 j (j < 4)
// or output columns tx + 16 j (j < NJ).  Rows are padded to D + 1 floats
// (D is even) so the threads of a warp hit distinct banks.  Four threads
// per row keep its running max and sum.  Key tiles wholly above the
// causal diagonal or left of the window are skipped: their weight is
// exp(-1e30 - m) = 0 once a real key has been seen, so the answer is the
// same.  It leaves the tensor cores (mma.sync / wgmma), cp.async / TMA
// and warp specialisation to the redesign: at about 34 GFLOP on the CUDA
// cores' 67 TFLOP/s f32 peak (same card and limit) it cannot come near
// the bound.
//
// Keys past Sk (the ragged last tile) score -inf, not -1e30, so they
// never count.  A row with no key in its window (only when Sq > Sk + W - 1)
// takes, as the reference does, the uniform average of all Sk values:
// its tile then walks every kv tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;      // q rows per block, and keys per kv tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// rows [row0, row0 + kTile) of a row-major (n_rows, d) matrix into dst
// (row stride ld) as f32; rows past the end read as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int row0, int n_rows, int d) {
  const T* base = src + (long long)row0 * d;
  const int valid = min(kTile, n_rows - row0) * d;
  for (int t = threadIdx.x; t < kTile * d; t += kThreads) {
    const int r = t / d;
    const int c = t - r * d;
    dst[r * ld + c] = t < valid ? Io<T>::load(base + t) : 0.f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int d, float scale, int causal, int window, float softcap) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                        // kTile x ld
  float* ks = qs + kTile * ld;             // kTile x ld
  float* vs = ks + kTile * ld;             // kTile x ld
  float* ps = vs + kTile * ld;             // kTile x (kTile + 1)
  float* corr_s = ps + kTile * (kTile + 1);
  float* l_s = corr_s + kTile;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int srow = threadIdx.x / 4;        // softmax: 4 threads per row
  const int spart = threadIdx.x % 4;
  const T* qb = q + (long long)bh * sq * d;
  const T* kb = k + (long long)bh * sk * d;
  const T* vb = v + (long long)bh * sk * d;

  int k_lo = 0, k_hi = sk;
  const bool unmatched_rows =
      window > 0 && min(q0 + kTile, sq) - 1 > sk + window - 2;
  if (!unmatched_rows) {
    if (causal) k_hi = min(sk, q0 + kTile);
    if (window > 0) k_lo = max(0, q0 - window + 1) / kTile * kTile;
  }

  load_tile(qs, ld, qb, q0, sq, d);

  float m_run = kNegInf, l_run = 0.f;      // row srow's running max, sum
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    __syncthreads();                       // last tile's ks, vs, ps consumed
    load_tile(ks, ld, kb, k0, sk, d);
    load_tile(vs, ld, vb, k0, sk, d);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int e = 0; e < d; ++e) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * ld + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + ty + 16 * i;
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool keep = true;
        if (causal) keep = keep && kp <= qp;
        if (window > 0) keep = keep && kp > qp - window;
        ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] =
            kp >= sk ? -INFINITY : (keep ? x : kNegInf);
      }
    }
    __syncthreads();

    // online softmax of row srow: new max, weights p, sum, correction
    float* prow = ps + srow * (kTile + 1);
    float mx = -INFINITY;
    for (int c = spart; c < kTile; c += 4) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    float sum = 0.f;
    for (int c = spart; c < kTile; c += 4) {
      const float p = expf(prow[c] - m_new);
      sum += p;
      prow[c] = Io<T>::round(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * corr + sum;
    m_run = m_new;
    if (spart == 0) corr_s[srow] = corr;
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
    for (int c = 0; c < kTile; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int e = tx + 16 * j;
        vv[j] = e < d ? vs[c * ld + e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  if (spart == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((long long)bh * sq + q0 + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = tx + 16 * j;
      if (e < d) Io<T>::store(orow + e, acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, int d, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const int ld = d + 1;
  const int smem = static_cast<int>(
      sizeof(float) * (3 * kTile * ld + kTile * (kTile + 1) + 2 * kTile));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, scale, causal,
      window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int sq, int sk, int d, float scale, int causal,
                     int window, float softcap, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 4>(q, k, v, o, bh, sq, sk, d, scale, causal, window,
                        softcap, stream);
  if (d <= 128)
    return launch<T, 8>(q, k, v, o, bh, sq, sk, d, scale, causal, window,
                        softcap, stream);
  return launch<T, 16>(q, k, v, o, bh, sq, sk, d, scale, causal, window,
                       softcap, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  d: a multiple of 8 up to 256.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, int bh,
                                          int sq, int sk, int d, int dtype,
                                          float scale, int causal, int window,
                                          float softcap, void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || bh <= 0 || sq <= 0 || sk <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, o, bh, sq, sk, d, scale, causal, window,
                            softcap, s)
          : dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, causal,
                                    window, softcap, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
