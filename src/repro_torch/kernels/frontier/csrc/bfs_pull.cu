// BFS pull step for Hopper: per row, the smallest neighbor id whose bit is
// set in the packed frontier bitmap, or INT_INF = 2^30 when none is, or
// when the row is already visited.
//
// Replaces the Pallas TPU kernel bfs_pull
// (src/repro/kernels/frontier/kernel.py, body _frontier_kernel).  The
// bitmap arrives as int32 storage and is read as uint32 words: bit
// (id & 31) of word (id >> 5).
//
// Bound on the H100: bytes.  Each slot of an unvisited row reads a 4-byte
// neighbor id and gathers one 4-byte bitmap word; each row reads its
// 4-byte unvisited flag and writes a 4-byte parent.  The bitmap is n/8
// bytes (512 KB at 4M vertices), so the gathers hit L2 and the index
// stream dominates.  The design reads the index stream coalesced (G
// consecutive lanes per row), skips every load of a visited row (late
// levels touch only the few unvisited rows), and reduces the group's
// candidates with a min shuffle.
//
// Mapping: a group of G lanes per row (G = the next power of two of K, at
// most 32); grid.y is the batch of stacked graph parts.  Inputs carry a
// batch stride; rows and slots are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIntInf = 1 << 30;

template <int G>
__global__ void __launch_bounds__(kThreads)
bfs_pull_kernel(const int* __restrict__ nbr, long long nbr_bs,
                const unsigned* __restrict__ bits, long long bits_bs,
                const int* __restrict__ unvisited, long long unv_bs,
                int* __restrict__ out, int rows, int k) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  // uniform across the row's group, so the shuffles below stay converged
  const bool live = row < rows && __ldg(unvisited + b * unv_bs + row) == 1;
  int best = kIntInf;
  if (live) {
    const int* nr = nbr + b * nbr_bs + row * k;
    const unsigned* wb = bits + b * bits_bs;
    for (int s = lane; s < k; s += G) {
      const int c = __ldg(nr + s);
      const unsigned word = __ldg(wb + (c >> 5));
      if ((word >> (c & 31)) & 1u) best = min(best, c);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    best = min(best, __shfl_xor_sync(0xffffffffu, best, off, G));
  }
  if (row < rows && lane == 0) out[(long long)b * rows + row] = best;
}

template <int G>
void launch(const int* nbr, long long nbr_bs, const unsigned* bits,
            long long bits_bs, const int* unv, long long unv_bs, int* out,
            int batch, int rows, int k, cudaStream_t stream) {
  const int rows_per_block = kThreads / G;
  dim3 grid((rows + rows_per_block - 1) / rows_per_block, batch);
  bfs_pull_kernel<G><<<grid, kThreads, 0, stream>>>(
      nbr, nbr_bs, bits, bits_bs, unv, unv_bs, out, rows, k);
}

}  // namespace

extern "C" int bfs_pull_launch(const void* nbr, long long nbr_bs,
                               const void* bits, long long bits_bs,
                               const void* unvisited, long long unv_bs,
                               void* out, int batch, int rows, int k,
                               void* stream) {
  const int* n = static_cast<const int*>(nbr);
  const unsigned* w = static_cast<const unsigned*>(bits);
  const int* u = static_cast<const int*>(unvisited);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) {
    launch<1>(n, nbr_bs, w, bits_bs, u, unv_bs, o, batch, rows, k, s);
  } else if (k <= 2) {
    launch<2>(n, nbr_bs, w, bits_bs, u, unv_bs, o, batch, rows, k, s);
  } else if (k <= 4) {
    launch<4>(n, nbr_bs, w, bits_bs, u, unv_bs, o, batch, rows, k, s);
  } else if (k <= 8) {
    launch<8>(n, nbr_bs, w, bits_bs, u, unv_bs, o, batch, rows, k, s);
  } else if (k <= 16) {
    launch<16>(n, nbr_bs, w, bits_bs, u, unv_bs, o, batch, rows, k, s);
  } else {
    launch<32>(n, nbr_bs, w, bits_bs, u, unv_bs, o, batch, rows, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bfs_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
