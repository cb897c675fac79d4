// Flash attention forward for Hopper: blocked online-softmax attention
// o = softmax(mask(softcap(q k^T / sqrt(D)))) v on (BH, S, D) tensors.
//
// Replaces the Pallas TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py, body _flash_kernel), and
// keeps its semantics: scores q k^T * D^-0.5 in f32, optional softcap
// tanh(s / c) * c, absolute positions qp = row and kp = col (no offset
// when Sq != Sk), causal and window masks at -1e30, exponentials relative
// to the running max, m, l and acc in f32, p rounded to the input type
// before the p @ v product, one division acc / max(l, 1e-30) at the end,
// output in the input type.  Keys past Sk (a ragged last tile) score
// -inf, not -1e30, so they never count.  A row with no key in its window
// (only when Sq > Sk + W - 1) takes, as the reference does, the uniform
// average of all Sk values: its tile then walks every kv tile.
//
// One difference from the Pallas kernel: there each tile's p @ v is a
// bf16 x bf16 dot_general, which returns bf16, so the tile's product is
// rounded to bf16 before it joins the f32 accumulator.  Here p @ v of a
// tile accumulates straight into the f32 accumulator; that is more exact,
// and within the 2e-2 bf16 tolerance of the reference's tests.
//
// Two designs, chosen by the input type (not one falling back on the
// other):
//
// bf16, the serving path: tensor cores.  Bound on the H100 SXM (data-sheet
// peaks, at its 700 W power limit): at TinyLlama-1.1B prefill (batch 8,
// S = 1024, 256 heads of D = 64, causal) q, k, v and o move about
// 0.134 GB, 0.040 ms at 3.35 TB/s; the causal score and p @ v work is
// about 34 GFLOP, 0.035 ms at the 989 TFLOP/s bf16 tensor-core peak.  The
// two are close, so the kernel must both stream q, k, v once and keep the
// tensor cores fed; at D = 64 the exponentials (one per score, 16 a clock
// on an SM) cost about as much as the products.  One block of 384 threads
// owns one (bh, 128-row q tile), walked heaviest first under causal
// masking so the long diagonal tiles do not form the tail:
//   - warpgroup 0 is the producer.  One thread loads the q tile once, then
//     the k and v tiles (Bk keys) into a ring of two stages, all by TMA
//     with 128-byte swizzle (a 64-column bf16 box fills a swizzle row
//     exactly); each k and each v tile has its own full/empty mbarrier
//     pair, so a k stage is refilled as soon as q k^T has read it.  q, k,
//     v and o are described as 3-D (BH, S, D) tensors, so the rows past S
//     of a ragged tile and the columns past D of a padded width are
//     zero-filled by TMA instead of read from the next head.
//   - warpgroups 1 and 2 are consumers, 64 q rows each, with the registers
//     the producer gives up (setmaxnreg).  S = q k^T is wgmma m64nBk k16,
//     both operands K-major in shared memory, bf16 in and f32 accumulate:
//     products of bf16 values are exact in f32, so this is the reference's
//     f32 dot_general of upcast values up to summation order.  The online
//     softmax runs on the accumulator fragment in registers (row max and
//     sum across the four threads of a quad); the mask is applied only on
//     tiles that cross the diagonal, the window edge or Sk.  O += P V is
//     wgmma with A = P from registers (the f32 accumulator layout of S is
//     the bf16 A-fragment layout of P) and B = the v tile, MN-major in
//     shared memory (transpose bit set).  Each iteration issues q k^T of
//     tile j and P V of tile j - 1 together, then runs the softmax of tile
//     j while the tensor cores finish P V.
//   - the epilogue divides by the row sum, writes bf16 into the consumer's
//     own q rows in shared memory (swizzled as TMA expects) and stores
//     them with one TMA store per 64 columns; rows past Sq and columns
//     past D are not written.
// Head dims: any multiple of 8 up to 256, padded to Dp = 64, 128 or 256
// with k tiles of Bk = 128, 64 or 32 keys (80, 96 and 128 KB of shared
// memory), the largest whose registers fit.  The scale is the true
// D^-0.5; padded columns are zeros and add 0 to every score.
// Exponentials are ex2.approx of scores pre-scaled by log2(e), and the
// final division is __fdividef (both within 2 ulp in f32, before the
// bf16 rounding of the output).
// What ptxas needs to keep the products asynchronous (otherwise it waits
// after every wgmma): every wgmma of a batch issued unconditionally, no
// function calls in the kernel (an IEEE f32 division is one), and no
// register of an in-flight wgmma written meanwhile (so the softmax writes
// p, not the score accumulator, and rounds p to bf16 only after P V of
// the tile before has completed).
// Optionally (lse != nullptr) both designs also write each row's f32
// log-sum-exp m + log(max(l, 1e-30)) in natural-log units, (BH, Sq): the
// residual the reference's custom VJP keeps for its backward.  It is
// written after o is, from the values o was divided by, so o has the same
// bits with or without it.  The bf16 design keeps m in log2 units and
// each row's l split over the four threads of a quad; after the quad's
// sum, the thread of lane % 4 == 0 writes lse = (m + lg2 l) ln 2 once a
// row.
// Left for later: ping-pong between the two consumers, a persistent grid
// that overlaps one tile's epilogue with the next tile's loads, and
// reading grouped kv heads in place.
//
// f32: the CUDA cores (tf32 tensor cores would not hold the 2e-5 of the
// reference's f32 tests).  One block of 256 threads takes one (bh, 64-row
// q tile): it stages q once in shared memory, then walks the 64-key tiles
// of k and v, staging each.  Thread (ty, tx) of the 16 x 16 grid owns rows
// ty + 16 i (i < 4), and score columns tx + 16 j (j < 4) or output columns
// tx + 16 j (j < NJ).  Rows are padded to D + 1 floats (D is even) so the
// threads of a warp hit distinct banks.  Four threads per row keep its
// running max and sum.  Key tiles wholly above the causal diagonal or
// left of the window are skipped in both designs: their weight is
// exp(-1e30 - m) = 0 once a real key has been seen, so the answer is the
// same.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTile = 64;      // q rows per block, and keys per kv tile
constexpr int kThreads = 256;  // 16 x 16

// rows [row0, row0 + kTile) of a row-major (n_rows, d) matrix into dst
// (row stride ld); rows past the end read as zeros
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int n_rows, int d) {
  const float* base = src + (long long)row0 * d;
  const int valid = min(kTile, n_rows - row0) * d;
  for (int t = threadIdx.x; t < kTile * d; t += kThreads) {
    const int r = t / d;
    const int c = t - r * d;
    dst[r * ld + c] = t < valid ? base[t] : 0.f;
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int d,
                     float scale, int causal, int window, float softcap) {
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
  const float* qb = q + (long long)bh * sq * d;
  const float* kb = k + (long long)bh * sk * d;
  const float* vb = v + (long long)bh * sk * d;

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
      prow[c] = p;
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
    float* orow = o + ((long long)bh * sq + q0 + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int e = tx + 16 * j;
      if (e < d) orow[e] = acc[i][j] / den;
    }
  }
  if (lse != nullptr && spart == 0 && q0 + srow < sq)
    lse[(long long)bh * sq + q0 + srow] = m_run + logf(fmaxf(l_run, 1e-30f));
}

template <int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int sq, int sk, int d, float scale,
                       int causal, int window, float softcap,
                       cudaStream_t stream) {
  const int ld = d + 1;
  const int smem = static_cast<int>(
      sizeof(float) * (3 * kTile * ld + kTile * (kTile + 1) + 2 * kTile));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kTile - 1) / kTile);
  flash_fwd_f32_kernel<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, d,
      scale, causal, window, softcap);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, float* lse, int bh, int sq, int sk, int d,
                         float scale, int causal, int window, float softcap,
                         cudaStream_t stream) {
  if (d <= 64)
    return launch_f32<4>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                         window, softcap, stream);
  if (d <= 128)
    return launch_f32<8>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                         window, softcap, stream);
  return launch_f32<16>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                        window, softcap, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kQRows = 128;        // q rows per block, 64 per consumer
constexpr int kTcThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kRowBytes = 128;     // one swizzled row: 64 bf16 columns
constexpr int kStages = 2;         // depth of the k and the v ring
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of one block, in bytes from a 1024-aligned base: q
// (boxes of 64 columns x 128 rows), then the k ring, then the v ring
// (each stage boxes of 64 columns x Bk rows), then the mbarriers:
// full_q, full_k[kStages], full_v[kStages], empty_k[kStages],
// empty_v[kStages]
template <int Dp, int Bk>
struct TcLayout {
  static constexpr int kBoxes = Dp / 64;
  static constexpr int kQBox = kQRows * kRowBytes;
  static constexpr int kKvBox = Bk * kRowBytes;
  static constexpr int kKvTile = kBoxes * kKvBox;   // one k or v stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kBar = kV + kStages * kKvTile;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block can use");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// box at column c0, row c1, head c2 of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keep registers that an in-flight wgmma reads or writes where they are
// until the wait before this point
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= a b over k16, a and b K-major in shared memory (scale_d = 0
// overwrites d): m64 x N, one call per 16 columns of D
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);

// d += a b over k16, a (64 x 16 bf16) from registers, b MN-major in
// shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}


// s = q k^T of this warpgroup's 64 rows against one k tile (issued, not
// waited for); columns past D are zeros
template <int Dp, int Bk, typename L>
__device__ __forceinline__ void issue_qk(float (&s)[Bk / 2], uint32_t q_wg,
                                         uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < Dp / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<Bk>(s, sw128_desc(q_wg + (kk / 4) * L::kQBox + off, 16, 1024),
                 sw128_desc(k_st + (kk / 4) * L::kKvBox + off, 16, 1024),
                 kk > 0);
  }
}

// o += p v of one v tile (issued, not waited for)
template <int Dp, int Bk, typename L>
__device__ __forceinline__ void issue_pv(float (&o)[Dp / 2],
                                         uint32_t (&pa)[Bk / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < Bk / 16; ++kk)
    wgmma_rs<Dp>(o, pa[kk],
                 sw128_desc(v_st + kk * 16 * kRowBytes, L::kKvBox, 1024), 1);
}

template <int Dp, int Bk>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to,
                    float* __restrict__ lse, int sq, int sk, int d,
                    float scale, int causal, int window, float softcap,
                    float inv_softcap) {
  using L = TcLayout<Dp, Bk>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base + L::kQ;
  const uint32_t full_q = base + L::kBar;
  auto full_k = [&](int st) { return full_q + 8 * (1 + st); };
  auto full_v = [&](int st) { return full_q + 8 * (1 + kStages + st); };
  auto empty_k = [&](int st) { return full_q + 8 * (1 + 2 * kStages + st); };
  auto empty_v = [&](int st) { return full_q + 8 * (1 + 3 * kStages + st); };
  auto k_tile = [&](int st) { return base + L::kK + st * L::kKvTile; };
  auto v_tile = [&](int st) { return base + L::kV + st * L::kKvTile; };

  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kQRows;
  int k_lo = 0, k_hi = sk;
  const bool unmatched_rows =
      window > 0 && min(q0 + kQRows, sq) - 1 > sk + window - 2;
  if (!unmatched_rows) {
    if (causal) k_hi = min(sk, q0 + kQRows);
    if (window > 0) k_lo = max(0, q0 - window + 1) / Bk * Bk;
  }
  const int n_tiles = (k_hi - k_lo + Bk - 1) / Bk;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 2 * 128);
      mbar_init(empty_v(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each warpgroup's role, uniform in each warp (setmaxnreg is per warp);
  // TMA zero-fills the columns past D of every box
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::kBoxes * L::kQBox);
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load(q_s + b * L::kQBox, &tq, full_q, 64 * b, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int parity = ((it / kStages) & 1) ^ 1;
        const int k0 = k_lo + it * Bk;
        if (it >= kStages) mbar_wait(empty_k(st), parity);
        mbar_expect_tx(full_k(st), L::kKvTile);
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load(k_tile(st) + b * L::kKvBox, &tk, full_k(st), 64 * b, k0,
                   bh);
        if (it >= kStages) mbar_wait(empty_v(st), parity);
        mbar_expect_tx(full_v(st), L::kKvTile);
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load(v_tile(st) + b * L::kKvBox, &tv, full_v(st), 64 * b, k0,
                   bh);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = role - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // accumulator element i of this thread sits at row
    // row + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + col + (i & 1)
    const int row = (t / 32) * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    const int r_lo = q0 + 64 * wg;           // this warpgroup's first row
    const uint32_t q_wg = q_s + 64 * wg * kRowBytes;
    const float scale_log2 = scale * kLog2e;

    // softmax of one tile: the raw scores of keys k0.. (the accumulator of
    // q k^T, left as it is) to f32 weights p, the correction of the old
    // sums, the new m and l.  Writing p, not the accumulator, keeps ptxas
    // from serializing the p v product that runs meanwhile.
    auto softmax = [&](const float (&acc)[Bk / 2], float (&p)[Bk / 2],
                       int k0, float (&m)[2], float (&l)[2],
                       float (&corr)[2]) {
      // raw q k^T times `factor` is in log2 units; tiles with a softcap or
      // a mask are brought to log2 units first (factor 1)
      const bool edge = k0 + Bk > sk || (causal && k0 + Bk - 1 > r_lo) ||
                        (window > 0 && k0 <= r_lo + 63 - window);
      float factor = scale_log2;
#pragma unroll
      for (int i = 0; i < Bk / 2; ++i) p[i] = acc[i];
      if (softcap > 0.f || edge) {
        factor = 1.f;
        if (softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < Bk / 2; ++i)
            p[i] = tanhf(p[i] * scale * inv_softcap) * softcap * kLog2e;
        } else {
#pragma unroll
          for (int i = 0; i < Bk / 2; ++i) p[i] *= scale_log2;
        }
        if (edge) {
#pragma unroll
          for (int i = 0; i < Bk / 2; ++i) {
            const int kp = k0 + 8 * (i >> 2) + col + (i & 1);
            const int qp = r_lo + row + 8 * ((i >> 1) & 1);
            if (kp >= sk)
              p[i] = -INFINITY;
            else if ((causal && kp > qp) ||
                     (window > 0 && kp <= qp - window))
              p[i] = kNegInf;
          }
        }
      }
      // rows row and row + 8, each spread over the four threads of a quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < Bk / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], p[i]);
      float neg_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * factor);
        corr[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        neg_m[h] = -m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < Bk / 2; ++i) {
        p[i] = ex2(fmaf(p[i], factor, neg_m[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += p[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
    };
    // p rounded to bf16 as the A fragments of p v: the f32 accumulator
    // layout of s is the bf16 A-fragment layout of p, k16 step by step
    auto to_bf16 = [&](const float (&p)[Bk / 2], uint32_t (&a)[Bk / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < Bk / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
    };

    float o[Dp / 2];
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    uint32_t pa[Bk / 16][4];                 // p of the previous tile, bf16
    mbar_wait(full_q, 0);
    {
      // tile 0: s = q k^T and its softmax (o is still zero)
      float s[Bk / 2], p[Bk / 2], corr[2];
      mbar_wait(full_k(0), 0);
      wgmma_fence();
      issue_qk<Dp, Bk, L>(s, q_wg, k_tile(0));
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      mbar_arrive(empty_k(0));
      softmax(s, p, k_lo, m, l, corr);
      to_bf16(p, pa);
    }
    // tile it: s = q k_it^T and o += p_{it-1} v_{it-1} are issued together;
    // the softmax of tile it runs while the tensor cores add p_{it-1} v,
    // and writes no register that product reads
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int pst = (it - 1) % kStages;
      float s[Bk / 2], p[Bk / 2], corr[2];
      hold(o);
      hold(pa);
      mbar_wait(full_k(st), (it / kStages) & 1);
      mbar_wait(full_v(pst), ((it - 1) / kStages) & 1);
      wgmma_fence();
      issue_qk<Dp, Bk, L>(s, q_wg, k_tile(st));
      wgmma_commit();
      issue_pv<Dp, Bk, L>(o, pa, v_tile(pst));
      wgmma_commit();
      wgmma_wait<1>();
      hold(s);
      mbar_arrive(empty_k(st));
      softmax(s, p, k_lo + it * Bk, m, l, corr);
      wgmma_wait<0>();
      hold(o);
      hold(pa);
      mbar_arrive(empty_v(pst));
#pragma unroll
      for (int i = 0; i < Dp / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      to_bf16(p, pa);
    }
    {
      // o += p v of the last tile
      const int lst = (n_tiles - 1) % kStages;
      hold(o);
      hold(pa);
      mbar_wait(full_v(lst), ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<Dp, Bk, L>(o, pa, v_tile(lst));
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(pa);
      mbar_arrive(empty_v(lst));
    }

    // epilogue: o / l in bf16 into this warpgroup's q rows, then TMA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        const uint32_t addr = q_wg + (j / 8) * L::kQBox + r * kRowBytes +
                              (((j % 8) ^ (r % 8)) * 16) + col * 2;
        const uint32_t val =
            pack_bf16(__fdividef(o[4 * j + 2 * h], l[h]),
                      __fdividef(o[4 * j + 2 * h + 1], l[h]));
        asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(val)
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (t == 0 && r_lo < sq) {
      for (int b = 0; 64 * b < d; ++b)
        tma_store(&to, q_wg + b * L::kQBox, 64 * b, r_lo, bh);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    // each row's lse from the quad's first thread, after o
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = r_lo + row + 8 * h;
        // a row that saw no key in its window kept m = -1e30 (a mask
        // value of log2 units here, of natural-log units in the
        // reference): its lse is -1e30 + log l, that is -1e30, as there
        if (qr < sq)
          lse[(long long)bh * sq + qr] =
              m[h] <= kNegInf ? kNegInf : (m[h] + lg2(l[h])) * kLn2;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the runtime has loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a (BH, S, D) bf16 tensor as a 3-D map, box of 64 columns x `rows` rows
// of one head, 128-byte swizzle, zero fill outside the tensor
bool encode_bhsd(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                 int bh, int s, int d, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Dp, int Bk>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int bh, int sq, int sk, int d, float scale,
                      int causal, int window, float softcap,
                      cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) |
                              reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) |
                              reinterpret_cast<uintptr_t>(o);
  if (addr_bits % 16 != 0) return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, to;
  if (!encode_bhsd(encode, &tq, q, bh, sq, d, kQRows) ||
      !encode_bhsd(encode, &tk, k, bh, sk, d, Bk) ||
      !encode_bhsd(encode, &tv, v, bh, sk, d, Bk) ||
      !encode_bhsd(encode, &to, o, bh, sq, d, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = TcLayout<Dp, Bk>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<Dp, Bk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (sq + kQRows - 1) / kQRows);
  flash_fwd_tc_kernel<Dp, Bk><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, to, lse, sq, sk, d, scale, causal, window, softcap,
      softcap > 0.f ? 1.f / softcap : 0.f);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, float* lse, int bh, int sq, int sk, int d,
                          float scale, int causal, int window, float softcap,
                          cudaStream_t stream) {
  if (d <= 64)
    return launch_tc<64, 128>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                              window, softcap, stream);
  if (d <= 128)
    return launch_tc<128, 64>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                              window, softcap, stream);
  return launch_tc<256, 32>(q, k, v, o, lse, bh, sq, sk, d, scale, causal,
                            window, softcap, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).
// d: a multiple of 8 up to 256.  lse: null, or (bh, sq) f32 to write each
// row's log-sum-exp into.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int bh, int sq, int sk, int d,
                                          int dtype, float scale, int causal,
                                          int window, float softcap,
                                          void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0 || bh <= 0 || sq <= 0 || sk <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch_f32(q, k, v, o, static_cast<float*>(lse), bh, sq, sk, d,
                         scale, causal, window, softcap, s)
          : dispatch_bf16(q, k, v, o, static_cast<float*>(lse), bh, sq, sk, d,
                          scale, causal, window, softcap, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
