// BFS pull step for Hopper over a table of ELL buckets, all in one launch:
// for every part p, bucket b and row r of b, the smallest neighbor id c
// in the row's K_b slots whose bit is set in the packed frontier bitmap
// (bit c & 31 of word c >> 5), or INT_INF = 2^30 when none is, or when
// the row's unvisited flag is not 1.  A slot equal to `skip` is a miss
// and is never read further.
//
// Replaces the Pallas TPU kernel bfs_pull
// (src/repro/kernels/frontier/kernel.py, body _frontier_kernel), which a
// TPU runs once per bucket with the bitmap in VMEM.  The bitmap arrives
// as int32 storage and is read as uint32 words; the flags as uint8 (or
// bool) or as int32, the TPU kernel's type.
//
// Bound on the H100: bytes.  Each slot of a live row reads a 4-byte
// neighbor id and gathers one 4-byte bitmap word; each row reads its flag
// and writes a 4-byte parent.  The bitmap is n/8 bytes (512 KB at 4M
// vertices), so the gathers hit L2, at the card's rate of random L1
// misses in a full pull round.  Most rounds of a BFS run have few live
// rows (push rounds pass only the newly activated rows): there the old
// design (one launch per bucket, a block per 256/G rows) paid for blocks
// that read a flag and exit, and this one walks such tiles at the cost of
// their flags (PERF.md has the per-round times).
//
// Design:
// - One persistent launch per call.  The bucket table rides in the kernel
//   parameters; the grid is the SM count times the resident blocks per
//   SM; each warp walks warp tiles (part-major, then bucket, then rows)
//   with a grid stride.
// - A warp tile is 32 rows, a thread per row, for K <= kNarrowMaxK.  The
//   warp reads its 32 flags coalesced and takes a ballot: a tile with no
//   live row reads no index.  A live lane reads kBatch ids of its row as
//   16-byte loads, issues all kBatch bitmap-word loads, then takes the
//   min.  Each warp reads the next tile's flags before it works on this
//   one.  Wider (hub) buckets take a warp per row: lanes read 32
//   consecutive slots each step, kWideBatch steps in flight, and the
//   warp takes the min by __reduce_min_sync.  The min is order-free, so
//   any mapping gives the exact result.
// - The bitmap is read under an L2 evict_last policy and the id stream
//   under evict_first.
//
// Inputs carry a part stride (the bitmap's may be 0: one bitmap for all
// parts); slots of a part are contiguous; flags and parents are indexed
// by output row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 64;   // MAX_BUCKETS in kernels/_ell.py
constexpr int kNarrowMaxK = 64;   // wider buckets: one warp per row
constexpr int kBatch = 16;        // word loads in flight per thread, narrow
constexpr int kWideBatch = 4;     // 32-slot steps in flight, wide
constexpr int kIntInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct Bucket {
  long long slot0;  // first slot of the bucket in a part's id row
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

template <typename F>
struct Args {
  const int* nbr;
  const unsigned* bits;
  const F* unvisited;
  int* out;
  long long nbr_bs, bits_bs, unv_bs, out_bs;
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

__device__ __forceinline__ unsigned ld_u32(const unsigned* p, uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int ld_s32(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int4 ld_v4(const int* p, uint64_t pol) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

// the candidate a slot holding id c gives: c if its frontier bit is set
__device__ __forceinline__ int candidate(int c, unsigned word) {
  return ((word >> (c & 31)) & 1u) ? c : kIntInf;
}

// one live row, one thread: min over its K slots
__device__ __forceinline__ int row_min(const int* ir, const unsigned* wb,
                                       int k, int skip, uint64_t pol_w,
                                       uint64_t pol_s) {
  const bool vec =
      (k & 3) == 0 && (reinterpret_cast<uintptr_t>(ir) & 15) == 0;
  int best = kIntInf;
  for (int s0 = 0; s0 < k; s0 += kBatch) {
    const int n = min(kBatch, k - s0);
    int c[kBatch];
    if (vec) {
#pragma unroll
      for (int j = 0; j < kBatch / 4; ++j) {
        int4 v = make_int4(0, 0, 0, 0);
        if (4 * j < n) v = ld_v4(ir + s0 + 4 * j, pol_s);
        c[4 * j] = v.x;
        c[4 * j + 1] = v.y;
        c[4 * j + 2] = v.z;
        c[4 * j + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        c[i] = i < n ? ld_s32(ir + s0 + i, pol_s) : 0;
      }
    }
    unsigned w[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      w[i] = (i < n && c[i] != skip) ? ld_u32(wb + (c[i] >> 5), pol_w) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) best = min(best, candidate(c[i], w[i]));
  }
  return best;
}

// one live row, one warp (hub widths): every lane returns the row's min
__device__ __forceinline__ int row_min_warp(const int* ir, const unsigned* wb,
                                            int k, int skip, int lane,
                                            uint64_t pol_w, uint64_t pol_s) {
  int best = kIntInf;
  for (int s0 = 0; s0 < k; s0 += 32 * kWideBatch) {
    int c[kWideBatch];
#pragma unroll
    for (int u = 0; u < kWideBatch; ++u) {
      const int s = s0 + 32 * u + lane;
      c[u] = s < k ? ld_s32(ir + s, pol_s) : skip;
    }
    unsigned w[kWideBatch];
#pragma unroll
    for (int u = 0; u < kWideBatch; ++u) {
      const int s = s0 + 32 * u + lane;
      w[u] = (s < k && c[u] != skip) ? ld_u32(wb + (c[u] >> 5), pol_w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kWideBatch; ++u) {
      best = min(best, candidate(c[u], w[u]));
    }
  }
  return __reduce_min_sync(kFull, best);
}

__device__ __forceinline__ int find_bucket(const Table& tab, int tile) {
  int b = 0;
  while (b + 1 < tab.nb && tab.b[b + 1].tile0 <= tile) ++b;
  return b;
}

// a warp tile of the walk, located: its part, its bucket, this lane's row
// (narrow) or the tile's one row (wide), and that row's flag
struct Tile {
  int part;
  const Bucket* b;
  int r;
  bool in;       // the row exists (narrow tiles may be ragged)
  bool live;     // and its flag is 1
};

template <typename F>
__device__ __forceinline__ Tile locate(const Args<F>& a, const Table& tab,
                                       long long t, int lane) {
  Tile w;
  w.part = (int)(t / tab.tiles);
  const int tile = (int)(t - (long long)w.part * tab.tiles);
  w.b = &tab.b[find_bucket(tab, tile)];
  const bool wide = w.b->k > kNarrowMaxK;
  w.r = wide ? tile - w.b->tile0 : (tile - w.b->tile0) * 32 + lane;
  w.in = w.r < w.b->rows;
  w.live = w.in && w.b->k > 0 &&
           a.unvisited[w.part * a.unv_bs + w.b->row0 + w.r] == 1;
  return w;
}

template <typename F>
__global__ void __launch_bounds__(kThreads, 4)
bfs_pull_kernel(const __grid_constant__ Args<F> a,
                const __grid_constant__ Table tab) {
  const int lane = threadIdx.x & 31;
  const uint64_t pol_w = policy_evict_last();
  const uint64_t pol_s = policy_evict_first();
  const long long total = (long long)tab.tiles * a.parts;
  const long long stride = (long long)gridDim.x * kWarps;
  long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= total) return;
  // the next tile's flags load while this tile's work runs, so a walk
  // over dead tiles does not wait on one flag load per tile
  Tile cur = locate(a, tab, t, lane);
  for (; t < total; t += stride) {
    Tile nx = cur;
    if (t + stride < total) nx = locate(a, tab, t + stride, lane);
    const Bucket& b = *cur.b;
    const int* ib = a.nbr + cur.part * a.nbr_bs + b.slot0 +
                    (long long)cur.r * b.k;
    const unsigned* wb = a.bits + cur.part * a.bits_bs;
    int* ob = a.out + cur.part * a.out_bs + b.row0;
    int best = kIntInf;
    if (b.k > kNarrowMaxK) {
      if (cur.live) {   // uniform over the warp
        best = row_min_warp(ib, wb, b.k, a.skip, lane, pol_w, pol_s);
      }
      if (lane == 0) ob[cur.r] = best;
    } else {
      if (__ballot_sync(kFull, cur.live) != 0 && cur.live) {
        best = row_min(ib, wb, b.k, a.skip, pol_w, pol_s);
      }
      if (cur.in) ob[cur.r] = best;
    }
    cur = nx;
  }
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_occ[2][kMaxDevices];

template <typename F>
cudaError_t launch(int which, const Args<F>& a, const Table& tab,
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
  if (g_occ[which][device] == 0) {   // resident blocks per SM, once
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bfs_pull_kernel<F>, kThreads, 0);
    if (err != cudaSuccess) return err;
    g_occ[which][device] = n > 0 ? n : 1;
  }
  const long long warps = (long long)tab.tiles * a.parts;
  const long long need = (warps + kWarps - 1) / kWarps;
  const long long full = (long long)g_sms[device] * g_occ[which][device];
  const int grid = (int)(need < full ? need : full);
  if (grid < 1) return cudaSuccess;
  bfs_pull_kernel<F><<<grid, kThreads, 0, stream>>>(a, tab);
  return cudaGetLastError();
}

template <typename F>
Args<F> make_args(const void* nbr, long long nbr_bs, const void* bits,
                  long long bits_bs, const void* unvisited, long long unv_bs,
                  void* out, long long out_bs, int parts, int skip) {
  Args<F> a;
  a.nbr = static_cast<const int*>(nbr);
  a.bits = static_cast<const unsigned*>(bits);
  a.unvisited = static_cast<const F*>(unvisited);
  a.out = static_cast<int*>(out);
  a.nbr_bs = nbr_bs;
  a.bits_bs = bits_bs;
  a.unv_bs = unv_bs;
  a.out_bs = out_bs;
  a.parts = parts;
  a.skip = skip;
  return a;
}

}  // namespace

// table: nb rows of (row0, slot0, rows, k), nb <= kMaxBuckets; flag_bytes
// is 1 (uint8 or bool flags) or 4 (int32).  Returns a cudaError_t.
extern "C" int bfs_pull_launch(const void* nbr, long long nbr_bs,
                               const void* bits, long long bits_bs,
                               const void* unvisited, long long unv_bs,
                               int flag_bytes, void* out, long long out_bs,
                               int parts, const long long* table, int nb,
                               int skip, void* stream) {
  if (nb < 1 || nb > kMaxBuckets || parts < 1 ||
      (flag_bytes != 1 && flag_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  cudaError_t err;
  if (flag_bytes == 1) {
    err = launch(0, make_args<unsigned char>(nbr, nbr_bs, bits, bits_bs,
                                             unvisited, unv_bs, out, out_bs,
                                             parts, skip), tab, s);
  } else {
    err = launch(1, make_args<int>(nbr, nbr_bs, bits, bits_bs, unvisited,
                                   unv_bs, out, out_bs, parts, skip), tab, s);
  }
  return static_cast<int>(err);
}

// The version of the C interface: 2 takes a bucket table (the first took
// one bucket a launch and exported no version).  kernel.py checks it.
extern "C" int bfs_pull_interface() { return 2; }

extern "C" const char* bfs_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
