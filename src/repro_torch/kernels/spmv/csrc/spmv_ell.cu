// ELL SpMV for Hopper over a table of ELL buckets, all in one launch:
// for every part p, bucket b and row r of b,
//   y[p, row0_b + r] = sum over s = 0 .. K_b - 1, left to right, of
//                      w[p, slot0_b + r * K_b + s] * x[p, idx[same slot]]
// with w the val tensor when one is given, else 1 for a slot whose index
// is not `skip` and 0 for one that is (the slot is then never read).
//
// Replaces the Pallas TPU kernel spmv_ell (src/repro/kernels/spmv/kernel.py,
// body _spmv_kernel), which a TPU runs once per bucket with x in VMEM.
//
// Bound on the H100: bytes.  Each slot reads a 4-byte index and gathers
// one 4-byte x value (plus a 4-byte weight with val); each row writes 4
// bytes; one add per slot.  What holds it above that bound is the rate of
// random gathers: each is an L1 miss that moves a 32-byte sector, from L2
// when x fits there (PageRank's pull: 16 MB at urand22) or from HBM when
// it does not (the push combine's 268 MB of per-edge values).  The old
// design (G lanes per row, one launch per bucket) already ran at that
// rate; this one keeps it with one launch per call, and keeps x in L2
// (PERF.md has the measurements).
//
// Design:
// - One persistent launch per call.  The bucket table (row offset, slot
//   offset, rows, K of each bucket) rides in the kernel parameters; the
//   grid is the SM count times the resident blocks per SM, and each warp
//   walks warp tiles (part-major, then bucket, then rows) with a grid
//   stride, so all buckets and all stacked parts take one launch.
// - A thread per row for K <= kNarrowMaxK: a warp tile is 32 rows.  The
//   lane reads up to kBatch indices of its row as 16-byte loads, then
//   issues all their gathers before it adds any, so each thread has up
//   to kBatch loads outstanding instead of one.  For wider (hub) buckets a
//   warp takes one row: lanes gather 32 consecutive slots each step,
//   kWideBatch steps in flight, and the warp adds them in slot order
//   through shuffles.
// - Sums in slot order, left to right, with __fadd_rn/__fmul_rn so nvcc
//   does not contract a product and a sum into an FMA: the result has the
//   bits of ref.py and of localops' ell path (acc starts at -0.0, the
//   additive identity of every float, so acc + a0 == a0 bit for bit).
// - x is read under an L2 evict_last policy and the index (and weight)
//   stream under evict_first, so the 4-byte-per-slot stream does not push
//   x out of L2.
// - The indices come straight from global memory.  A per-warp two-stage
//   ring that staged them in shared memory by cp.async.bulk on an
//   mbarrier was timed against these direct loads on the main path's
//   inputs and was slower on every one, so it is not built (PERF.md).
//
// Inputs carry a part stride (x's may be 0: one vector for all parts);
// slots of a part are contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 64;   // MAX_BUCKETS in kernels/_ell.py
constexpr int kNarrowMaxK = 64;   // wider buckets: one warp per row
// gathers in flight per thread: 32 was faster than 8 or 16 on the main
// path's buckets (PERF.md has the sweep)
constexpr int kBatch = 32;
// blocks per SM the launch bound asks for: 2 leaves registers for a batch
// of 32 (index, gathered value and, with val, weight per slot)
constexpr int kMinBlocks = 2;
constexpr int kWideBatch = 4;     // 32-slot steps in flight, wide
constexpr unsigned kFull = 0xffffffffu;

struct Bucket {
  long long slot0;  // first slot of the bucket in a part's idx row
  int row0;         // first output row of the bucket
  int rows;
  int k;
  int tile0;        // first warp tile of the bucket within a part
};

struct Table {
  Bucket b[kMaxBuckets];
  int nb;
  int tiles;        // warp tiles of one part
};

struct Args {
  const int* idx;
  const float* val;
  const float* x;
  float* y;
  long long idx_bs, val_bs, x_bs, y_bs;
  int parts;
  int skip;
};

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}


__device__ __forceinline__ float ld_f32(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_s32(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int4 ld_v4(const void* p, uint64_t pol) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

template <typename T>
__device__ __forceinline__ T from_bits(int v);
template <>
__device__ __forceinline__ int from_bits<int>(int v) { return v; }
template <>
__device__ __forceinline__ float from_bits<float>(int v) {
  return __int_as_float(v);
}

// n (<= kBatch) consecutive 32-bit words from p into c; 16-byte loads when
// vec (p 16-byte aligned, n a multiple of 4)
template <typename T>
__device__ __forceinline__ void load_batch(const T* p, int n, bool vec,
                                           T (&c)[kBatch], uint64_t pol) {
  static_assert(sizeof(T) == 4, "32-bit words");
  if (vec) {
#pragma unroll
    for (int j = 0; j < kBatch / 4; ++j) {
      int4 v = make_int4(0, 0, 0, 0);
      if (4 * j < n) v = ld_v4(p + 4 * j, pol);
      c[4 * j] = from_bits<T>(v.x);
      c[4 * j + 1] = from_bits<T>(v.y);
      c[4 * j + 2] = from_bits<T>(v.z);
      c[4 * j + 3] = from_bits<T>(v.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      c[i] = i < n ? from_bits<T>(ld_s32(
                         reinterpret_cast<const int*>(p + i), pol))
                   : T(0);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one row, one thread: the slot-order sum of its K slots
template <bool HAS_VAL>
__device__ __forceinline__ float row_sum(const int* ir, const float* vr,
                                         const float* xb, int k, int skip,
                                         uint64_t pol_x, uint64_t pol_s) {
  const bool vec = (k & 3) == 0 && aligned16(ir) &&
                   (!HAS_VAL || aligned16(vr));
  float acc = -0.0f;
  for (int s0 = 0; s0 < k; s0 += kBatch) {
    const int n = min(kBatch, k - s0);
    int c[kBatch];
    float w[kBatch];
    load_batch(ir + s0, n, vec, c, pol_s);
    if (HAS_VAL) load_batch(vr + s0, n, vec, w, pol_s);
    float g[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      g[i] = (i < n && (HAS_VAL || c[i] != skip)) ? ld_f32(xb + c[i], pol_x)
                                                   : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i < n) acc = __fadd_rn(acc, HAS_VAL ? __fmul_rn(w[i], g[i]) : g[i]);
    }
  }
  return acc;
}

// one row, one warp (hub widths): every lane returns the slot-order sum
template <bool HAS_VAL>
__device__ __forceinline__ float row_sum_warp(const int* ir, const float* vr,
                                              const float* xb, int k,
                                              int skip, int lane,
                                              uint64_t pol_x,
                                              uint64_t pol_s) {
  float acc = -0.0f;
  for (int s0 = 0; s0 < k; s0 += 32 * kWideBatch) {
    int c[kWideBatch];
    float g[kWideBatch];
#pragma unroll
    for (int u = 0; u < kWideBatch; ++u) {
      const int s = s0 + 32 * u + lane;
      c[u] = s < k ? ld_s32(ir + s, pol_s) : skip;
      g[u] = (s < k && HAS_VAL) ? ld_f32(vr + s, pol_s) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kWideBatch; ++u) {
      const int s = s0 + 32 * u + lane;
      const bool take = s < k && (HAS_VAL || c[u] != skip);
      const float xv = take ? ld_f32(xb + c[u], pol_x) : 0.0f;
      g[u] = HAS_VAL ? __fmul_rn(g[u], xv) : xv;
    }
#pragma unroll
    for (int u = 0; u < kWideBatch; ++u) {
      const int m = min(32, k - (s0 + 32 * u));   // uniform over the warp
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const float v = __shfl_sync(kFull, g[u], i);
        if (i < m) acc = __fadd_rn(acc, v);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ int find_bucket(const Table& tab, int tile) {
  int b = 0;
  while (b + 1 < tab.nb && tab.b[b + 1].tile0 <= tile) ++b;
  return b;
}

template <bool HAS_VAL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmv_ell_kernel(const __grid_constant__ Args a,
                const __grid_constant__ Table tab) {
  const int lane = threadIdx.x & 31;
  // x under evict_last: PageRank's pull gathers each value of its 16 MB x
  // about 16 times, and a push combine reads its per-edge values 8 to a
  // 32-byte sector (evict_normal was no faster, PERF.md)
  const uint64_t pol_x = policy_evict_last();
  const uint64_t pol_s = policy_evict_first();
  const long long total = (long long)tab.tiles * a.parts;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       t < total; t += stride) {
    const int part = (int)(t / tab.tiles);
    const int tile = (int)(t - (long long)part * tab.tiles);
    const Bucket& b = tab.b[find_bucket(tab, tile)];
    const int* ib = a.idx + part * a.idx_bs + b.slot0;
    const float* vb = HAS_VAL ? a.val + part * a.val_bs + b.slot0 : nullptr;
    const float* xb = a.x + part * a.x_bs;
    float* yb = a.y + part * a.y_bs + b.row0;
    if (b.k > kNarrowMaxK) {
      const int r = tile - b.tile0;
      const long long o = (long long)r * b.k;
      const float acc = row_sum_warp<HAS_VAL>(
          ib + o, HAS_VAL ? vb + o : nullptr, xb, b.k, a.skip, lane, pol_x,
          pol_s);
      if (lane == 0) yb[r] = acc;
    } else {
      const int r = (tile - b.tile0) * 32 + lane;
      if (r < b.rows) {
        const long long o = (long long)r * b.k;
        yb[r] = b.k == 0 ? 0.0f
                         : row_sum<HAS_VAL>(ib + o, HAS_VAL ? vb + o : nullptr,
                                            xb, b.k, a.skip, pol_x, pol_s);
      }
    }
  }
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_occ[2][kMaxDevices];   // by design: 0 val, 1 skip

// resident blocks per SM of design `which`
cudaError_t occupancy(int which, int* n) {
  return which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          n, spmv_ell_kernel<true>, kThreads, 0)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          n, spmv_ell_kernel<false>, kThreads, 0);
}

// one persistent launch: the SM count times the resident blocks per SM
// (queried once per device), or fewer when there are fewer warp tiles
cudaError_t launch(int which, const Args& a, const Table& tab,
                   cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  if (g_occ[which][device] == 0) {
    int n = 0;
    err = occupancy(which, &n);
    if (err != cudaSuccess) return err;
    g_occ[which][device] = n > 0 ? n : 1;
  }
  const long long warps = (long long)tab.tiles * a.parts;
  const long long need = (warps + kWarps - 1) / kWarps;
  const long long full = (long long)g_sms[device] * g_occ[which][device];
  const int grid = (int)(need < full ? need : full);
  if (grid < 1) return cudaSuccess;
  if (which == 0) {
    spmv_ell_kernel<true><<<grid, kThreads, 0, stream>>>(a, tab);
  } else {
    spmv_ell_kernel<false><<<grid, kThreads, 0, stream>>>(a, tab);
  }
  return cudaGetLastError();
}

}  // namespace

// table: nb rows of (row0, slot0, rows, k), nb <= kMaxBuckets.  Returns a
// cudaError_t (0 on success).
extern "C" int spmv_ell_launch(const void* idx, long long idx_bs,
                               const void* val, long long val_bs,
                               const void* x, long long x_bs, void* y,
                               long long y_bs, int parts,
                               const long long* table, int nb, int skip,
                               void* stream) {
  if (nb < 1 || nb > kMaxBuckets || parts < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.idx = static_cast<const int*>(idx);
  a.val = static_cast<const float*>(val);
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.idx_bs = idx_bs;
  a.val_bs = val_bs;
  a.x_bs = x_bs;
  a.y_bs = y_bs;
  a.parts = parts;
  a.skip = skip;
  Table tab;
  long long tiles = 0;
  for (int i = 0; i < nb; ++i) {
    Bucket& b = tab.b[i];
    b.row0 = static_cast<int>(table[4 * i]);
    b.slot0 = table[4 * i + 1];
    b.rows = static_cast<int>(table[4 * i + 2]);
    b.k = static_cast<int>(table[4 * i + 3]);
    b.tile0 = static_cast<int>(tiles);
    tiles += b.k > kNarrowMaxK ? b.rows : (b.rows + 31) / 32;
  }
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tab.nb = nb;
  tab.tiles = static_cast<int>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(a.val != nullptr ? 0 : 1, a, tab, s));
}

// The version of the C interface: 2 takes a bucket table (the first took
// one bucket a launch and exported no version).  kernel.py checks it.
extern "C" int spmv_ell_interface() { return 2; }

extern "C" const char* spmv_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
