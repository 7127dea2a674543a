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
// would carry it through 0 * NaN).  The sums accumulate in float64 and are
// rounded to float32 once, by the kernel.  block_tile must be nondecreasing,
// as build_tile_layout emits it: a tile's blocks are consecutive.
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
// here the work is bound by bytes.  Each CTA takes kBlocksPerCta consecutive
// edge blocks and keeps a float64 tile_v x d_chunk accumulator in shared
// memory.  Windows are grid y; the feature axis is cut into d_chunk columns
// on grid z so that the accumulator fits the 48 KB of a static launch.
// - Warp-aggregated adds.  On the power-law layout about half of all edges
//   land on one hub vertex, so half the lanes of a warp would add into one
//   shared slot and serialise.  Instead the lanes of a warp are grouped by
//   slot (__match_any_sync; masked and out-of-range lanes get keys of their
//   own and join no group), each group's float64 values are summed in
//   registers by a shuffle tree, and one leader lane per distinct slot
//   issues the shared atomicAdd.
// - 16-byte loads.  For D = 1 (PageRank) dst_local, valid and the messages
//   are read as int4 / float4, four edges per lane, wherever the block size
//   and the pointers allow (a variant chosen by the launcher).  Where a
//   block is a multiple of 4 * kThreads edges (the main path's 1024), the
//   loads run a round ahead of the adds and there is no barrier between
//   blocks of one tile.
// - A flush without a zero-filled output.  A tile whose blocks all lie in
//   one CTA is rounded to float32 and written by that CTA.  A tile shared by
//   several CTAs (the hub tile spans about 950) is added, nonzero slots
//   only, into a float64 scratch tile with global atomics (fire-and-forget
//   reductions at L2); the last of its CTAs to finish, found by one
//   atomicAdd on a per-tile counter (every CTA adds 1, the tile's first CTA
//   adds its own index and its last CTA a bias less its index, so the count
//   reaches kLastBias exactly when all have added), rounds the scratch tile
//   into out and zeroes scratch and counter for the next call.  Tiles that
//   own no block are found by binary searches of block_tile spread over
//   the CTAs, and zeroed.
//
// Accuracy.  On a power-law graph a hub's slot sums millions of similar
// terms; added one by one in float32 they drift by up to the term count
// times float32's epsilon (a float32 version of this kernel put PageRank's
// ranks 9.3e-5 of the top rank off a float64 oracle on the H100, PERF.md).
// In float64 the result is within one float32 rounding of the exact sum.
// Tiles of one CTA add in a fixed order; the shared tiles' global float64
// atomics do not, so two identical calls round to the same float32 unless
// an exact sum lies within float64 rounding of a float32 rounding boundary.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = 8;
constexpr int kSmemSlots = 48 * 1024 / static_cast<int>(sizeof(double));
constexpr int kLastBias = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// acc[slot] += x for every lane of the warp with slot >= 0, one shared
// atomicAdd per distinct slot.  Every lane of the warp must call it.
__device__ __forceinline__ void warp_add(double* acc, int slot, double x) {
  const int lane = threadIdx.x & 31;
  const unsigned key = slot >= 0 ? static_cast<unsigned>(slot) : (0x80000000u | lane);
  unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  int rel = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  peers &= 0xfffffffeu << lane;                   // peers above it
  // a tree over each group: in round r the lanes whose rank has its low r
  // bits clear add the value of their next remaining peer
  while (__any_sync(kFull, peers != 0)) {
    const int next = __ffs(peers);
    const double t = __shfl_sync(kFull, x, (next - 1) & 31);
    if (next) x += t;
    peers &= ~__ballot_sync(kFull, rel & 1);
    rel >>= 1;
  }
  if (slot >= 0 && leader == lane) atomicAdd(acc + slot, x);
}

__device__ __forceinline__ int slot_of(int j, int ok, int tile_v) {
  return ok != 0 && static_cast<unsigned>(j) < static_cast<unsigned>(tile_v) ? j : -1;
}

// grid = (ceil(n_blocks / kBlocksPerCta), n_windows, ceil(d / dc)); window w
// reads valid[w, :] and messages[w, :, :] and writes out[w, :, :, :].
// scratch [n_windows, n_tiles, tile_v, d] (float64) and counter
// [n_windows, grid.z, n_tiles] are zero between calls.
__global__ void __launch_bounds__(kThreads)
segment_spmm_tiles_kernel(const int* __restrict__ dst_local,
                          const float* __restrict__ msg,
                          const int* __restrict__ valid,
                          const int* __restrict__ block_tile,
                          float* __restrict__ out, double* __restrict__ scratch,
                          int* __restrict__ counter, int n_blocks, int n_tiles,
                          int tile_v, int block_e, int d, int dc_max, int vec4,
                          int streamed) {
  extern __shared__ double acc[];  // all of the 48 KB: no static shared memory
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const long long tile_size = static_cast<long long>(tile_v) * d;
  const int c0 = blockIdx.z * dc_max;
  const int dc = min(dc_max, d - c0);  // this chunk's width
  const int n_acc = tile_v * dc;
  msg += static_cast<long long>(blockIdx.y) * ep * d;
  valid += static_cast<long long>(blockIdx.y) * ep;
  out += static_cast<long long>(blockIdx.y) * n_tiles * tile_size + c0;
  scratch += static_cast<long long>(blockIdx.y) * n_tiles * tile_size + c0;
  counter += (static_cast<long long>(blockIdx.y) * gridDim.z + blockIdx.z) * n_tiles;

  const int b0 = blockIdx.x * kBlocksPerCta;
  const int b1 = min(b0 + kBlocksPerCta, n_blocks);
  for (int i = tid; i < n_acc; i += kThreads) acc[i] = 0.0;

  // The streamed variant (D = 1, block_e a multiple of 4 * kThreads): every
  // thread loads one 16-byte piece of dst_local, valid and messages per
  // round of kThreads pieces, a round ahead of the one it adds.
  const int per_block = block_e / (4 * kThreads);  // rounds per block
  const int4* s_dl = reinterpret_cast<const int4*>(dst_local) + tid;
  const int4* s_ok = reinterpret_cast<const int4*>(valid) + tid;
  const float4* s_ms = reinterpret_cast<const float4*>(msg) + tid;
  int4 j4 = make_int4(-1, -1, -1, -1), v4 = make_int4(0, 0, 0, 0);
  float4 m4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (streamed) {
    const long long o = static_cast<long long>(b0) * per_block * kThreads;
    j4 = __ldg(s_dl + o);
    v4 = __ldg(s_ok + o);
    m4 = __ldg(s_ms + o);
  }

  // Tiles that own no block read 0.  CTA x tests tiles x, x + gridDim.x,
  // ..., one per lane (a binary search of the nondecreasing block_tile);
  // every warp searches the same tiles and zeroes its share of the empty.
  for (int t0 = blockIdx.x; t0 < n_tiles; t0 += 32 * gridDim.x) {
    const long long t = t0 + static_cast<long long>(lane) * gridDim.x;
    bool empty = false;
    if (t < n_tiles) {
      int lo = 0, hi = n_blocks;  // the first block of a tile >= t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (block_tile[mid] < t) lo = mid + 1; else hi = mid;
      }
      empty = lo == n_blocks || block_tile[lo] != t;
    }
    for (unsigned mask = __ballot_sync(kFull, empty); mask != 0; mask &= mask - 1) {
      float* dst = out + (t0 + static_cast<long long>(__ffs(mask) - 1) * gridDim.x) * tile_size;
      for (int i = tid; i < n_acc; i += kThreads) {
        const int row = i / dc;
        dst[static_cast<long long>(row) * d + (i - row * dc)] = 0.0f;
      }
    }
  }
  __syncthreads();

  // Finish tile t, whose blocks in this CTA are [bs, be): write it, or add
  // it to the shared scratch tile; leaves acc zero.
  auto finish = [&](int t, int bs, int be) {
    if (static_cast<unsigned>(t) >= static_cast<unsigned>(n_tiles)) return;
    const bool first = bs == 0 || block_tile[bs - 1] != t;  // the tile starts here
    const bool last = be == n_blocks || block_tile[be] != t;  // and ends here
    float* dst = out + t * tile_size;
    double* sc = scratch + t * tile_size;
    if (first && last) {
      for (int i = tid; i < n_acc; i += kThreads) {
        const int row = i / dc;
        dst[static_cast<long long>(row) * d + (i - row * dc)] = static_cast<float>(acc[i]);
        acc[i] = 0.0;
      }
    } else {
      for (int i = tid; i < n_acc; i += kThreads) {
        const double x = acc[i];
        if (x != 0.0) {  // a NaN compares unequal and is added too
          const int row = i / dc;
          atomicAdd(sc + static_cast<long long>(row) * d + (i - row * dc), x);
          acc[i] = 0.0;
        }
      }
      __threadfence();  // the adds land before the count says so
      __syncthreads();
      bool done = false;
      if (tid == 0) {
        const int add = 1 + (first ? static_cast<int>(blockIdx.x) : 0) +
                        (last ? kLastBias - static_cast<int>(blockIdx.x) - 1 : 0);
        done = atomicAdd(counter + t, add) + add == kLastBias;
      }
      if (__syncthreads_or(done)) {  // this CTA is the tile's last
        __threadfence();
        for (int i = tid; i < n_acc; i += kThreads) {
          const int row = i / dc;
          const long long off = static_cast<long long>(row) * d + (i - row * dc);
          dst[off] = static_cast<float>(__ldcg(sc + off));
          __stcg(sc + off, 0.0);
        }
        if (tid == 0) counter[t] = 0;
      }
    }
    __syncthreads();
  };

  int cur = block_tile[b0], seg = b0;
  if (streamed) {
    const int r1 = b1 * per_block;
    for (int r = b0 * per_block; r < r1; ++r) {
      int4 jn = j4, vn = v4;
      float4 mn = m4;
      if (r + 1 < r1) {  // the next round's loads before this round's adds
        const long long o = static_cast<long long>(r + 1) * kThreads;
        jn = __ldg(s_dl + o);
        vn = __ldg(s_ok + o);
        mn = __ldg(s_ms + o);
      }
      const int b = r / per_block;
      const int t = block_tile[b];  // uniform across the CTA
      if (t != cur) {
        __syncthreads();
        finish(cur, seg, b);
        cur = t;
        seg = b;
      }
      if (static_cast<unsigned>(t) < static_cast<unsigned>(n_tiles)) {
        warp_add(acc, slot_of(j4.x, v4.x, tile_v), m4.x);
        warp_add(acc, slot_of(j4.y, v4.y, tile_v), m4.y);
        warp_add(acc, slot_of(j4.z, v4.z, tile_v), m4.z);
        warp_add(acc, slot_of(j4.w, v4.w, tile_v), m4.w);
      }
      j4 = jn;
      v4 = vn;
      m4 = mn;
    }
    __syncthreads();
  }
  for (int b = streamed ? b1 : b0; b < b1; ++b) {
    const int t = block_tile[b];  // uniform across the CTA
    if (t != cur) {
      finish(cur, seg, b);
      cur = t;
      seg = b;
    }
    if (static_cast<unsigned>(t) >= static_cast<unsigned>(n_tiles)) continue;
    const long long base = static_cast<long long>(b) * block_e;
    if (dc == 1 && vec4) {
      // four edges per lane: 16-byte loads of dst_local, valid and messages
      const int4* dl = reinterpret_cast<const int4*>(dst_local + base);
      const int4* ok = reinterpret_cast<const int4*>(valid + base);
      const float4* ms = reinterpret_cast<const float4*>(msg + base);
      const int n4 = block_e / 4;
      for (int i0 = warp * 32; i0 < n4; i0 += kThreads) {  // uniform per warp
        const int i = i0 + lane;
        int4 j = make_int4(-1, -1, -1, -1), v = make_int4(0, 0, 0, 0);
        float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n4) {
          j = __ldg(dl + i);
          v = __ldg(ok + i);
          m = __ldg(ms + i);
        }
        warp_add(acc, slot_of(j.x, v.x, tile_v), m.x);
        warp_add(acc, slot_of(j.y, v.y, tile_v), m.y);
        warp_add(acc, slot_of(j.z, v.z, tile_v), m.z);
        warp_add(acc, slot_of(j.w, v.w, tile_v), m.w);
      }
    } else if (dc == 1) {
      for (int i0 = warp * 32; i0 < block_e; i0 += kThreads) {
        const int i = i0 + lane;
        int s = -1;
        double x = 0.0;
        if (i < block_e) {
          const long long e = base + i;
          s = slot_of(dst_local[e], valid[e], tile_v);
          if (s >= 0) x = static_cast<double>(msg[e * d + c0]);
        }
        warp_add(acc, s, x);
      }
    } else {
      // (edge, column) pairs, neighbouring lanes on neighbouring columns;
      // lanes of one slot meet only when a warp spans several edges
      const int n = block_e * dc;
      for (int i0 = warp * 32; i0 < n; i0 += kThreads) {
        const int i = i0 + lane;
        int s = -1;
        double x = 0.0;
        if (i < n) {
          const int r = i / dc;
          const int c = i - r * dc;
          const long long e = base + r;
          const int j = slot_of(dst_local[e], valid[e], tile_v);
          if (j >= 0) {
            s = j * dc + c;
            x = static_cast<double>(msg[e * d + c0 + c]);
          }
        }
        if (dc < 32) {
          warp_add(acc, s, x);
        } else if (s >= 0) {
          atomicAdd(acc + s, x);
        }
      }
    }
    __syncthreads();
  }
  finish(cur, seg, b1);
}

}  // namespace

// Plain C interface (loaded with ctypes).  `out` is float32 [n_windows,
// n_tiles, tile_v, d], written whole.  `scratch` (float64, n_windows *
// n_tiles * tile_v * d elements) and `counter` (int32, n_windows *
// ceil(d / d_chunk) * n_tiles elements, d_chunk = min(d, 6144 / tile_v))
// must be zero before the first call, and every call leaves them zero;
// reuse them only on one stream.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int segment_spmm_tiles_launch(const int* dst_local, const float* msg,
                                         const int* valid, const int* block_tile,
                                         float* out, double* scratch, int* counter,
                                         int n_blocks, int n_tiles, int tile_v,
                                         int block_e, int d, int n_windows,
                                         void* stream) {
  if (n_blocks <= 0 || n_tiles <= 0 || tile_v <= 0 || tile_v > kSmemSlots ||
      block_e <= 0 || d <= 0 || n_windows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dc = min(d, kSmemSlots / tile_v);
  const dim3 grid((n_blocks + kBlocksPerCta - 1) / kBlocksPerCta, n_windows,
                  (d + dc - 1) / dc);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec4 = d == 1 && block_e % 4 == 0 && aligned(dst_local) && aligned(msg) &&
                   aligned(valid);
  const int streamed = vec4 && block_e % (4 * kThreads) == 0;
  const size_t smem = static_cast<size_t>(tile_v) * dc * sizeof(double);
  segment_spmm_tiles_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dst_local, msg, valid, block_tile, out, scratch, counter, n_blocks, n_tiles, tile_v,
      block_e, d, dc, vec4, streamed);
  return static_cast<int>(cudaGetLastError());
}
