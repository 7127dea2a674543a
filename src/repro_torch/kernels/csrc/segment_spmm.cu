// Tiled segment-sum kernel for Hopper (sm_90a): the f32 sum combine of every
// PageRank iteration over the destination-tile edge layout (kernels/layout.py).
//
// segment_spmm_tiles_kernel replaces the Pallas kernel
//   src/repro/kernels/segment_spmm.py::segment_spmm_tiles.
//
// What it computes: out[w, t, j, :] = the sum, over the layout's edge blocks b
// with block_tile[b] == t and the edges e of b with dst_local[e] == j and
// valid[w, e] != 0, of messages[w, e, :]; zero where nothing lands.  A masked
// lane contributes nothing at all: it is skipped, never multiplied by zero,
// so a NaN message in a masked lane stays out (the TPU's one-hot product
// would carry it through 0 * NaN).
//
// Bound: memory bytes.  Each padded edge slot is read once: 4 B dst_local
// (shared by the W windows) plus, per window, 4 B valid and 4*D B of message;
// each output slot is written once, 4*D B per window.  The work is one add
// per valid message element, far below the card's rate.  At the power-law
// main path's layout (8,335,360 slots, 2,227 tiles of 512) and D = 1 that is
// 104.6 MB, 0.031 ms at 3.35 TB/s, for one window, and 603 MB, 0.180 ms,
// for W = 8.
//
// Design.  The TPU grid walks a tile's blocks in order and carries the sum in
// the aliased output, turning each block into a one-hot [tile_v, block_e] x
// [block_e, tile_d] product for its matrix unit.  That product is dropped:
// here the work is bound by bytes.  Blocks run in no order, so, as in the
// tile-min kernels, each CTA takes kBlocksPerCta consecutive edge blocks
// (consecutive blocks mostly share a tile), keeps a tile_v x d_chunk
// accumulator in shared memory, adds each valid message element into it with
// a shared-memory atomicAdd, and when the tile changes or its blocks end
// flushes each nonzero slot into the zero-filled output with one global
// atomicAdd.  Windows are grid y; the feature axis is cut into d_chunk
// columns on grid z so that tile_v * d_chunk * 8 B stays within the 48 KB of
// static-launch shared memory.
//
// Accuracy.  Both accumulators are float64, and the wrapper rounds the
// result to float32 once.  On a power-law graph a hub's slot sums millions
// of similar terms; added one by one in float32 they drift by up to the term
// count times float32's epsilon (a float32 version of this kernel put
// PageRank's ranks 9.3e-5 of the top rank off a float64 oracle on the H100,
// PERF.md).  In float64 the result is within one float32 rounding of the
// exact sum.  The float64 additions still run in no
// fixed order, so bit-reproducibility is not guaranteed: two identical calls
// round to the same float32 unless an exact sum lies within float64 rounding
// of a float32 rounding boundary.  The float64 shared atomics cost time on
// the hub tile, whose 512 slots also take one global atomic per CTA and slot
// at flush; both are left for a later revision.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = 8;
constexpr int kSmemSlots = 48 * 1024 / static_cast<int>(sizeof(double));

// Flush the shared accumulator (tile_v rows of `dc` columns) into out's tile
// `tile`, columns [c0, c0 + dc), and reset it to zero.  Each thread touches
// only its own slots, so no barrier is needed between the read and the
// reset.  A NaN compares unequal to zero and is flushed.
__device__ __forceinline__ void flush_tile(double* acc, double* __restrict__ out,
                                           int tile, int n_tiles, int tile_v,
                                           int d, int c0, int dc) {
  const bool in_range = static_cast<unsigned>(tile) < static_cast<unsigned>(n_tiles);
  double* dst = out + static_cast<long long>(tile) * tile_v * d + c0;
  const int n = tile_v * dc;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double v = acc[i];
    if (v != 0.0) {
      if (in_range) {
        const int row = i / dc;
        atomicAdd(dst + static_cast<long long>(row) * d + (i - row * dc), v);
      }
      acc[i] = 0.0;
    }
  }
}

// grid = (ceil(n_blocks / kBlocksPerCta), n_windows, ceil(d / dc)); window w
// reads valid[w, :] and messages[w, :, :] and writes out[w, :, :, :].
__global__ void __launch_bounds__(kThreads)
segment_spmm_tiles_kernel(const int* __restrict__ dst_local,
                          const float* __restrict__ msg,
                          const int* __restrict__ valid,
                          const int* __restrict__ block_tile,
                          double* __restrict__ out, int n_blocks, int n_tiles,
                          int tile_v, int block_e, int d, int dc_max) {
  extern __shared__ double acc[];
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const int c0 = blockIdx.z * dc_max;
  const int dc = min(dc_max, d - c0);  // this chunk's width
  msg += static_cast<long long>(blockIdx.y) * ep * d;
  valid += static_cast<long long>(blockIdx.y) * ep;
  out += static_cast<long long>(blockIdx.y) * n_tiles * tile_v * d;

  const int b0 = blockIdx.x * kBlocksPerCta;
  const int b1 = min(b0 + kBlocksPerCta, n_blocks);
  for (int i = threadIdx.x; i < tile_v * dc; i += blockDim.x) acc[i] = 0.0;
  int cur = block_tile[b0];
  __syncthreads();
  for (int b = b0; b < b1; ++b) {
    const int t = block_tile[b];  // uniform across the CTA
    if (t != cur) {
      flush_tile(acc, out, cur, n_tiles, tile_v, d, c0, dc);
      cur = t;
      __syncthreads();
    }
    const long long base = static_cast<long long>(b) * block_e;
    if (dc == 1) {
      // one column: one edge per thread, coalesced 4 B loads
      for (int i = threadIdx.x; i < block_e; i += blockDim.x) {
        const long long e = base + i;
        const int j = dst_local[e];
        if (valid[e] != 0 && static_cast<unsigned>(j) < static_cast<unsigned>(tile_v)) {
          atomicAdd(acc + j, static_cast<double>(msg[e * d + c0]));
        }
      }
    } else {
      // (edge, column) pairs, neighbouring threads on neighbouring columns
      const int n = block_e * dc;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / dc;
        const int c = i - r * dc;
        const long long e = base + r;
        const int j = dst_local[e];
        if (valid[e] != 0 && static_cast<unsigned>(j) < static_cast<unsigned>(tile_v)) {
          atomicAdd(acc + j * dc + c, static_cast<double>(msg[e * d + c0 + c]));
        }
      }
    }
    __syncthreads();
  }
  flush_tile(acc, out, cur, n_tiles, tile_v, d, c0, dc);
}

}  // namespace

// Plain C interface (loaded with ctypes).  `out` is the float64 sum buffer
// [n_windows, n_tiles, tile_v, d] and must be zero-filled by the caller.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int segment_spmm_tiles_launch(const int* dst_local, const float* msg,
                                         const int* valid, const int* block_tile,
                                         double* out, int n_blocks, int n_tiles,
                                         int tile_v, int block_e, int d,
                                         int n_windows, void* stream) {
  if (n_blocks <= 0 || tile_v <= 0 || tile_v > kSmemSlots || block_e <= 0 ||
      d <= 0 || n_windows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dc = min(d, kSmemSlots / tile_v);
  const dim3 grid((n_blocks + kBlocksPerCta - 1) / kBlocksPerCta, n_windows,
                  (d + dc - 1) / dc);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(tile_v) * dc * sizeof(double);
  segment_spmm_tiles_kernel<<<grid, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      dst_local, msg, valid, block_tile, out, n_blocks, n_tiles, tile_v,
      block_e, d, dc);
  return static_cast<int>(cudaGetLastError());
}
