// ELL SpMV for Hopper: y[b, r] = sum_k w[b, r, k] * x[b, idx[b, r, k]].
//
// Replaces the Pallas TPU kernel spmv_ell (src/repro/kernels/spmv/kernel.py,
// body _spmv_kernel).  w is the val tensor when one is given, else
// (idx != skip): the main path passes no val and skips the ELL sentinel,
// so it reads no per-slot weights at all.
//
// Bound on the H100: bytes.  Each slot reads a 4-byte index and gathers a
// 4-byte x value (plus a 4-byte weight with val), each row writes 4 bytes;
// there is one multiply-add per slot, far below the card's arithmetic
// rate.  The gathers are random, so the design keeps them cheap: x (16 MB
// at 4M vertices) stays resident in the 50 MB L2, the index stream is read
// coalesced (G consecutive lanes read G consecutive slots of a row), and
// the row sum is a shuffle reduction with no shared memory.
//
// Mapping: a group of G lanes per row (G = the next power of two of K,
// at most 32), lanes stride over the row's K slots, then a butterfly
// shuffle reduces the group.  grid.y is the batch of stacked graph parts,
// so one launch serves all parts of one ELL bucket.  Inputs carry a batch
// stride; rows and slots are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int G, bool HAS_VAL>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int* __restrict__ idx, long long idx_bs,
                const float* __restrict__ val, long long val_bs,
                const float* __restrict__ x, long long x_bs,
                float* __restrict__ y, int rows, int k, int skip) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x % G;
  const long long row =
      (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  float acc = 0.f;
  if (row < rows) {
    const int* ir = idx + b * idx_bs + row * k;
    const float* xb = x + b * x_bs;
    const float* vr = HAS_VAL ? val + b * val_bs + row * k : nullptr;
    for (int s = lane; s < k; s += G) {
      const int c = __ldg(ir + s);
      if (HAS_VAL) {
        acc += __ldg(vr + s) * __ldg(xb + c);
      } else if (c != skip) {
        acc += __ldg(xb + c);
      }
    }
  }
  // every lane of the warp takes part, rows past the end with acc = 0
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
  }
  if (row < rows && lane == 0) y[(long long)b * rows + row] = acc;
}

template <int G>
void launch(const int* idx, long long idx_bs, const float* val,
            long long val_bs, const float* x, long long x_bs, float* y,
            int batch, int rows, int k, int skip, cudaStream_t stream) {
  const int rows_per_block = kThreads / G;
  dim3 grid((rows + rows_per_block - 1) / rows_per_block, batch);
  if (val != nullptr) {
    spmv_ell_kernel<G, true><<<grid, kThreads, 0, stream>>>(
        idx, idx_bs, val, val_bs, x, x_bs, y, rows, k, skip);
  } else {
    spmv_ell_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        idx, idx_bs, val, val_bs, x, x_bs, y, rows, k, skip);
  }
}

}  // namespace

extern "C" int spmv_ell_launch(const void* idx, long long idx_bs,
                               const void* val, long long val_bs,
                               const void* x, long long x_bs, void* y,
                               int batch, int rows, int k, int skip,
                               void* stream) {
  const int* i = static_cast<const int*>(idx);
  const float* v = static_cast<const float*>(val);
  const float* xs = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) {
    launch<1>(i, idx_bs, v, val_bs, xs, x_bs, out, batch, rows, k, skip, s);
  } else if (k <= 2) {
    launch<2>(i, idx_bs, v, val_bs, xs, x_bs, out, batch, rows, k, skip, s);
  } else if (k <= 4) {
    launch<4>(i, idx_bs, v, val_bs, xs, x_bs, out, batch, rows, k, skip, s);
  } else if (k <= 8) {
    launch<8>(i, idx_bs, v, val_bs, xs, x_bs, out, batch, rows, k, skip, s);
  } else if (k <= 16) {
    launch<16>(i, idx_bs, v, val_bs, xs, x_bs, out, batch, rows, k, skip, s);
  } else {
    launch<32>(i, idx_bs, v, val_bs, xs, x_bs, out, batch, rows, k, skip, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spmv_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
