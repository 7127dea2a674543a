// Tile-min kernels for Hopper (sm_90a): the min-combine of every earliest-
// arrival round over the destination-tile edge layout (kernels/layout.py).
//
// segment_min_tiles_kernel replaces the Pallas kernel
//   src/repro/kernels/temporal_edgemap.py::segment_min_tiles
// and temporal_relax_min_tiles_kernel replaces
//   src/repro/kernels/temporal_edgemap.py::temporal_relax_min_tiles.
//
// What they compute: out[t, j] = min over the layout's edge blocks b with
// block_tile[b] == t, and the edges e of b with dst_local[e] == j, of the
// candidate cand[e]; INT_MAX where nothing lands.  The relax kernel first
// forms the candidate from the earliest-arrival predicate
//   ok = valid & ts >= ta & te <= tb & (arr <= ts, or arr < ts if strict)
//        & arr < INT_MAX,   cand = ok ? te : INT_MAX.
//
// Bound: memory bytes.  Each padded edge slot is read once, 8 B for the
// plain min (dst_local, cand) and 20 B for the relax (dst_local, arr, ts,
// te, valid), plus 4 B per output slot written; a handful of integer
// operations per slot is far below the card's rate.
//
// Design.  The TPU grid walks a tile's blocks one after another and carries
// the minimum in the aliased output.  Here blocks run concurrently and in no
// order, and one CTA per tile would be wrong for skewed graphs: on a power-
// law graph most edge blocks belong to the hub tile.  So each CTA takes
// kBlocksPerCta consecutive edge blocks (consecutive blocks mostly share a
// tile, since the layout groups them), keeps a tile_v-slot int32 accumulator
// in shared memory, min-combines each finite candidate into it with a
// shared-memory atomicMin, and when the tile changes or its blocks end
// flushes each finite slot into the INT_MAX-filled output with one global
// atomicMin.  A min is order-free, so the result is bit-exact whatever the
// order of blocks and atomics.  Loads are coalesced 4 B per thread; the
// hub tile's global atomics and vector loads are the work of a later
// revision.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = 8;

// Flush the shared accumulator into out's tile `tile` and reset it to
// INT_MAX.  Each thread touches only its own slots, so no barrier is
// needed between the read and the reset.
__device__ __forceinline__ void flush_tile(int* acc, int* __restrict__ out,
                                           int tile, int n_tiles,
                                           int tile_v) {
  const bool in_range = static_cast<unsigned>(tile) < static_cast<unsigned>(n_tiles);
  int* dst = out + static_cast<long long>(tile) * tile_v;
  for (int j = threadIdx.x; j < tile_v; j += blockDim.x) {
    const int v = acc[j];
    if (v != INT_MAX) {
      if (in_range) atomicMin(dst + j, v);
      acc[j] = INT_MAX;
    }
  }
}

// The per-CTA body shared by both kernels; `cand(e)` yields edge slot e's
// candidate (INT_MAX = nothing).
template <class Cand>
__device__ __forceinline__ void tile_min_cta(const int* __restrict__ dst_local,
                                             const int* __restrict__ block_tile,
                                             int* __restrict__ out,
                                             int n_blocks, int n_tiles,
                                             int tile_v, int block_e,
                                             const Cand& cand) {
  extern __shared__ int acc[];
  const int b0 = blockIdx.x * kBlocksPerCta;
  const int b1 = min(b0 + kBlocksPerCta, n_blocks);
  for (int j = threadIdx.x; j < tile_v; j += blockDim.x) acc[j] = INT_MAX;
  int cur = block_tile[b0];
  __syncthreads();
  for (int b = b0; b < b1; ++b) {
    const int t = block_tile[b];  // uniform across the CTA
    if (t != cur) {
      flush_tile(acc, out, cur, n_tiles, tile_v);
      cur = t;
      __syncthreads();
    }
    const long long base = static_cast<long long>(b) * block_e;
    for (int i = threadIdx.x; i < block_e; i += blockDim.x) {
      const long long e = base + i;
      const int c = cand(e);
      const int d = dst_local[e];
      if (c != INT_MAX && static_cast<unsigned>(d) < static_cast<unsigned>(tile_v)) {
        atomicMin(acc + d, c);
      }
    }
    __syncthreads();
  }
  flush_tile(acc, out, cur, n_tiles, tile_v);
}

struct PlainCand {
  const int* __restrict__ cand;
  __device__ __forceinline__ int operator()(long long e) const { return cand[e]; }
};

struct RelaxCand {
  const int* __restrict__ arr;
  const int* __restrict__ ts;
  const int* __restrict__ te;
  const int* __restrict__ valid;
  int ta;
  int tb;
  int strict;
  __device__ __forceinline__ int operator()(long long e) const {
    const int a = arr[e];
    const int s = ts[e];
    const int t = te[e];
    const bool follows = strict ? (a < s) : (a <= s);
    const bool ok = valid[e] != 0 && s >= ta && t <= tb && follows && a < INT_MAX;
    return ok ? t : INT_MAX;
  }
};

// grid = (ceil(n_blocks / kBlocksPerCta), n_windows); window w reads
// cand[w, :] and writes out[w, :, :].
__global__ void __launch_bounds__(kThreads)
segment_min_tiles_kernel(const int* __restrict__ dst_local,
                         const int* __restrict__ cand,
                         const int* __restrict__ block_tile,
                         int* __restrict__ out, int n_blocks, int n_tiles,
                         int tile_v, int block_e) {
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const PlainCand c{cand + blockIdx.y * ep};
  int* o = out + static_cast<long long>(blockIdx.y) * n_tiles * tile_v;
  tile_min_cta(dst_local, block_tile, o, n_blocks, n_tiles, tile_v, block_e, c);
}

__global__ void __launch_bounds__(kThreads)
temporal_relax_min_tiles_kernel(const int* __restrict__ dst_local,
                                const int* __restrict__ arr,
                                const int* __restrict__ ts,
                                const int* __restrict__ te,
                                const int* __restrict__ valid,
                                const int* __restrict__ block_tile,
                                int* __restrict__ out, int n_blocks,
                                int n_tiles, int tile_v, int block_e, int ta,
                                int tb, int strict) {
  const RelaxCand c{arr, ts, te, valid, ta, tb, strict};
  tile_min_cta(dst_local, block_tile, out, n_blocks, n_tiles, tile_v, block_e, c);
}

dim3 grid_for(int n_blocks, int n_windows) {
  return dim3((n_blocks + kBlocksPerCta - 1) / kBlocksPerCta, n_windows);
}

}  // namespace

// Plain C interface (loaded with ctypes).  `out` must be INT_MAX-filled by
// the caller.  Each returns cudaGetLastError() after the launch.
extern "C" int segment_min_tiles_launch(const int* dst_local, const int* cand,
                                        const int* block_tile, int* out,
                                        int n_blocks, int n_tiles, int tile_v,
                                        int block_e, int n_windows,
                                        void* stream) {
  const size_t smem = static_cast<size_t>(tile_v) * sizeof(int);
  segment_min_tiles_kernel<<<grid_for(n_blocks, n_windows), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      dst_local, cand, block_tile, out, n_blocks, n_tiles, tile_v, block_e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int temporal_relax_min_tiles_launch(
    const int* dst_local, const int* arr, const int* ts, const int* te,
    const int* valid, const int* block_tile, int* out, int n_blocks,
    int n_tiles, int tile_v, int block_e, int ta, int tb, int strict,
    void* stream) {
  const size_t smem = static_cast<size_t>(tile_v) * sizeof(int);
  temporal_relax_min_tiles_kernel<<<grid_for(n_blocks, 1), kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      dst_local, arr, ts, te, valid, block_tile, out, n_blocks, n_tiles,
      tile_v, block_e, ta, tb, strict);
  return static_cast<int>(cudaGetLastError());
}
