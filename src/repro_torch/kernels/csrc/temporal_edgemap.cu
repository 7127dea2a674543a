// Tile-min kernels for Hopper (sm_90a): the min-combine of every earliest-
// arrival round over the destination-tile edge layout (kernels/layout.py).
//
// segment_min_tiles_kernel (K1) replaces the Pallas kernel
//   src/repro/kernels/temporal_edgemap.py::segment_min_tiles
// and temporal_relax_min_tiles_kernel (K2) replaces
//   src/repro/kernels/temporal_edgemap.py::temporal_relax_min_tiles.
//
// What they compute: out[w, t, j] = min over the layout's edge blocks b
// with block_tile[b] == t, and the edges e of b with dst_local[e] == j, of
// window w's candidate cand[w, e]; INT_MAX where nothing lands.  Lanes whose
// dst_local is outside [0, tile_v) or whose block's tile is outside
// [0, n_tiles) are masked.  K2 (one window) first forms the candidate from
// the earliest-arrival predicate
//   ok = valid & ts >= ta & te <= tb & (arr <= ts, or arr < ts if strict)
//        & arr < INT_MAX,   cand = ok ? te : INT_MAX.
// block_tile must be nondecreasing, as build_tile_layout emits it: a tile's
// blocks are consecutive (the CPU wrappers check; the card does not).
//
// Bound: memory bytes.  Each padded edge slot is read once: 4 B of
// dst_local, shared by the W windows, and 4 B of candidate per window (K2:
// 16 B of arr, ts, te, valid); each output slot is written once, 4 B per
// window.  At the power-law main path's layout (8,335,360 slots, 2,227
// tiles of 512) that is 71 MB, 0.021 ms at 3.35 TB/s, for one window and
// 1.25 GB, 0.372 ms, for W = 32.  A handful of integer operations per slot
// is far below the card's rate.
//
// Design.  The TPU grid walks a tile's blocks in order and carries the
// minimum in the aliased, INT_MAX-initialised output.  Here CTAs run in no
// order.  Each takes a fixed span of slots (4,096 for K1, 1,024 for K2; the
// launch shapes below) and a chunk of up to 32 windows (grid y), and keeps
// one tile_v accumulator per window in shared memory, min-combined with
// shared-memory atomics.  On the power-law layout 7,616 of 8,140 blocks
// belong to hub tile 0 and 1,726 of 2,227 tiles own none.  Against the four
// losses of the first design (one window per CTA, an INT_MAX-filled
// output, 4-byte loads with a barrier per block, global atomics into the
// hub tile):
// - Windows inside the CTA.  Each thread loads its slots of dst_local once,
//   as 16-byte loads, into registers (two 16-bit ids a register), and loops
//   over the chunk's windows; per window all its 16-byte candidate loads
//   are issued before any atomic.  dst_local crosses HBM once per call up
//   to W = 32 (it was read W times: 1.07 GB of a 2.3 GB total at W = 32).
//   With one window the candidates are loaded with dst_local, in one round
//   trip, as streaming (evict-first) loads.
// - No INT_MAX pre-fill: every output slot is written once, by the kernel.
//   A tile whose blocks all lie in one CTA is stored whole with 16-byte
//   stores, INT_MAX included.  A tile that owns no block is stored INT_MAX
//   by one CTA, found from tile_start (each tile's first block, derived once
//   per layout by kernels/ops.py::tile_starts).
// - Bytes in flight: 16-byte loads, and no barrier until the tile changes
//   or the CTA's slots end (the first design ended every 1,024-slot block
//   in a CTA-wide barrier).
// - The hub.  A tile shared by several CTAs (the hub spans ~1,900) goes
//   through a scratch tile instead of global atomicMins into a pre-filled
//   output: each CTA adds its finite slots with fire-and-forget atomicMax
//   reductions of INT_MAX - v (an unsigned order reversal, so that a zero
//   scratch is the identity and the stream's zeroed buffer serves), and the
//   last of the tile's CTAs, found by one atomicAdd on a per-(chunk, tile)
//   counter (every CTA adds 1, the tile's first CTA its own index and its
//   last CTA a bias less its index, so the count reaches kLastBias exactly
//   when all have added), stores the scratch tile into out and zeroes
//   scratch and counter for the next call.
// CTAs take their slots in reverse launch order, so that the slowest (the
// many small tiles after a power-law hub) start first.  A min is
// order-free, so the result is bit-exact whatever the order of CTAs and
// atomics.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Launch shapes, measured on the H100 (PERF.md): threads a CTA, rounds of
// 16-byte loads a thread holds (a round is 4 slots a thread), and CTAs per
// SM the registers must allow.
constexpr int kOneThreads = 256, kOneRounds = 4, kOneMinCtas = 4;        // K1, one window
constexpr int kManyThreads = 512, kManyRounds = 2, kManyMinCtas = 3;     // K1, W > 1
constexpr int kRelaxThreads = 256, kRelaxRounds = 1, kRelaxMinCtas = 5;  // K2
constexpr int kMaxWarps = 32;
constexpr unsigned kMasked = 0xffffu;  // a 16-bit local id that lands nowhere
constexpr int kLastBias = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

// p[e .. e+3], `fill` at or past n.  With `vec` (n a multiple of 4, p
// 16-byte aligned) one 16-byte load, marked as streaming (evict first) with
// kStream: the one-window kernels read every byte once.
template <bool kStream>
__device__ __forceinline__ int4 load4(const int* __restrict__ p, long long e,
                                      long long n, bool vec, int fill) {
  if (vec) {
    if (e >= n) return make_int4(fill, fill, fill, fill);
    const int4* q = reinterpret_cast<const int4*>(p + e);
    return kStream ? __ldcs(q) : __ldg(q);
  }
  return make_int4(e < n ? __ldg(p + e) : fill, e + 1 < n ? __ldg(p + e + 1) : fill,
                   e + 2 < n ? __ldg(p + e + 2) : fill,
                   e + 3 < n ? __ldg(p + e + 3) : fill);
}

// The unsigned order reversal of the scratch tiles: v -> INT_MAX - v maps
// INT_MAX to 0 and a smaller v to a larger value, over all of int32.
__device__ __forceinline__ unsigned flip(int v) {
  return static_cast<unsigned>(INT_MAX) - static_cast<unsigned>(v);
}
__device__ __forceinline__ int unflip(unsigned u) {
  return static_cast<int>(static_cast<unsigned>(INT_MAX) - u);
}

// dst[w * plane + j] = acc[w * tile_v + j] (then acc = INT_MAX), or INT_MAX
// when acc is null, for w < nw and j < tile_v; every thread calls it.
template <int kThreads>
__device__ __forceinline__ void store_tile(int* __restrict__ dst, long long plane, int nw,
                                           int tile_v, int* acc) {
  if ((tile_v & 3) == 0) {  // dst and acc are then 16-byte aligned
    const int q = tile_v >> 2;
    const int4 inf = make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
    for (int i = threadIdx.x; i < nw * q; i += kThreads) {
      const int w = i / q;
      int4 v = inf;
      if (acc) {
        v = reinterpret_cast<int4*>(acc)[i];
        reinterpret_cast<int4*>(acc)[i] = inf;
      }
      reinterpret_cast<int4*>(dst + w * plane)[i - w * q] = v;
    }
  } else {
    for (int i = threadIdx.x; i < nw * tile_v; i += kThreads) {
      const int w = i / tile_v;
      int v = INT_MAX;
      if (acc) {
        v = acc[i];
        acc[i] = INT_MAX;
      }
      dst[w * plane + (i - w * tile_v)] = v;
    }
  }
}

// The per-CTA body shared by both kernels; cand is PlainCand or RelaxCand.
// grid = (ceil(Ep / kCtaSlots), ceil(n_windows / wc)); CTA (x, y) takes the
// kCtaSlots slots from x * kCtaSlots and windows [y * wc, ...).  kOne: one
// window, whose candidates are loaded with dst_local.  out is [n_windows,
// n_tiles, tile_v]; scratch (the same shape) and counter [grid y, n_tiles]
// are zero between calls.
template <int kThreads, int kRounds, bool kOne, class Cand>
__device__ __forceinline__ void tile_min_cta(const int* __restrict__ dst_local,
                                             const int* __restrict__ block_tile,
                                             const int* __restrict__ tile_start,
                                             int* __restrict__ out,
                                             unsigned* __restrict__ scratch,
                                             int* __restrict__ counter, int n_blocks,
                                             int n_tiles, int tile_v, int block_e,
                                             int n_windows, int wc, bool vec,
                                             const Cand& cand) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kRoundSlots = 4 * kThreads;
  constexpr int kCtaSlots = kRounds * kRoundSlots;
  extern __shared__ int4 smem[];  // 16-byte aligned
  int* acc = reinterpret_cast<int*>(smem);  // [wc, tile_v]
  int* empty = acc + wc * tile_v;           // [kWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // CTAs start in blockIdx order; the last slots go first: on a power-law
  // layout they hold the many small tiles after the hub, the CTAs that take
  // longest
  const int x = gridDim.x - 1 - blockIdx.x;
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const long long lo = static_cast<long long>(x) * kCtaSlots;
  const long long hi = min(lo + kCtaSlots, ep);
  const int w0 = blockIdx.y * wc;
  const int nw = kOne ? 1 : min(wc, n_windows - w0);
  const long long plane = static_cast<long long>(n_tiles) * tile_v;
  out += w0 * plane;
  scratch += w0 * plane;
  counter += static_cast<long long>(blockIdx.y) * n_tiles;

  // This thread's slots lo + r * kRoundSlots + 4 * tid + k: dst_local once
  // for every window, two 16-bit ids a register (tile_v <= 12288), kMasked
  // past the CTA's slots or out of [0, tile_v); with one window, its
  // candidates in the same round trip.
  unsigned dl[kRounds][2];
  int4 c1[kOne ? kRounds : 1];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long e = lo + r * kRoundSlots + 4 * tid;
    const int4 v = load4<kOne>(dst_local, e, hi, vec, -1);
    if constexpr (kOne) c1[r] = cand.template get<true>(w0, e, hi);
    const auto id = [tile_v](int d) {
      return static_cast<unsigned>(d) < static_cast<unsigned>(tile_v)
                 ? static_cast<unsigned>(d) : kMasked;
    };
    dl[r][0] = id(v.x) | id(v.y) << 16;
    dl[r][1] = id(v.z) | id(v.w) << 16;
  }

  for (int i = tid; i < nw * tile_v; i += kThreads) acc[i] = INT_MAX;
  // Tiles that own no block (tile_start[t] == tile_start[t + 1]) read
  // INT_MAX: warp k of CTA x checks tile x + k * gridDim.x (and so on), and
  // the CTA stores the empty ones.
  for (long long t0 = x; t0 < n_tiles; t0 += static_cast<long long>(kWarps) * gridDim.x) {
    const long long t = t0 + static_cast<long long>(warp) * gridDim.x;
    if (lane == 0) {
      empty[warp] = t < n_tiles && tile_start[t] == tile_start[t + 1] ? static_cast<int>(t) : -1;
    }
    __syncthreads();
    for (int k = 0; k < kWarps; ++k) {
      if (empty[k] >= 0) {
        store_tile<kThreads>(out + empty[k] * static_cast<long long>(tile_v), plane, nw,
                             tile_v, nullptr);
      }
    }
    __syncthreads();
  }
  __syncthreads();

  // The CTA's slots in runs of one tile: blocks [b, be), slots [s_lo, s_hi)
  // as offsets from lo.
  for (int b = static_cast<int>(lo / block_e); static_cast<long long>(b) * block_e < hi;) {
    const int t = block_tile[b];  // uniform across the CTA
    int be = b + 1;  // the run's end, 32 blocks a step, each warp alike
    for (;; be += 32) {
      const int bl = be + lane;
      const unsigned m = __ballot_sync(
          kFull, static_cast<long long>(bl) * block_e >= hi || block_tile[bl] != t);
      if (m != 0) {
        be += __ffs(m) - 1;
        break;
      }
    }
    const long long b_lo = static_cast<long long>(b) * block_e;
    const long long b_hi = static_cast<long long>(be) * block_e;
    if (static_cast<unsigned>(t) < static_cast<unsigned>(n_tiles)) {
      const int s_lo = static_cast<int>(max(lo, b_lo) - lo);
      const int s_hi = static_cast<int>(min(hi, b_hi) - lo);
      for (int w = 0; w < nw; ++w) {
        int4 c[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {  // every load before any atomic
          const int base = r * kRoundSlots;
          if constexpr (kOne) {
            c[r] = c1[r];
          } else {
            c[r] = base < s_hi && base + kRoundSlots > s_lo
                       ? cand.template get<false>(w0 + w, lo + base + 4 * tid, hi)
                       : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
          }
        }
        int* a = acc + w * tile_v;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
          const int v[4] = {c[r].x, c[r].y, c[r].z, c[r].w};
          const int s = r * kRoundSlots + 4 * tid;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const unsigned d = dl[r][k >> 1] >> (16 * (k & 1)) & kMasked;
            if (v[k] != INT_MAX && d != kMasked && s + k >= s_lo && s + k < s_hi) {
              atomicMin(a + d, v[k]);
            }
          }
        }
      }
      __syncthreads();

      // Finish tile t: the tile starts in this CTA if its first block
      // does, and ends here if its last block does.
      const bool first = b_lo >= lo && (b == 0 || block_tile[b - 1] != t);
      const bool last = b_hi <= hi && (be == n_blocks || block_tile[be] != t);
      if (first && last) {
        store_tile<kThreads>(out + t * static_cast<long long>(tile_v), plane, nw, tile_v, acc);
      } else {
        unsigned* sc = scratch + t * static_cast<long long>(tile_v);
        bool sent = false;
        for (int i = tid; i < nw * tile_v; i += kThreads) {
          const int v = acc[i];
          if (v != INT_MAX) {
            const int w = i / tile_v;
            atomicMax(sc + w * plane + (i - w * tile_v), flip(v));
            acc[i] = INT_MAX;
            sent = true;
          }
        }
        if (sent) __threadfence();  // the reductions land before the count says so
        __syncthreads();
        bool done = false;
        if (tid == 0) {
          const int add = 1 + (first ? x : 0) + (last ? kLastBias - x - 1 : 0);
          done = atomicAdd(counter + t, add) + add == kLastBias;
        }
        if (__syncthreads_or(done)) {  // this CTA is the tile's last
          __threadfence();
          int* dst = out + t * static_cast<long long>(tile_v);
          for (int i = tid; i < nw * tile_v; i += kThreads) {
            const int w = i / tile_v;
            const long long off = w * plane + (i - w * tile_v);
            dst[off] = unflip(__ldcg(sc + off));
            __stcg(sc + off, 0u);
          }
          if (tid == 0) counter[t] = 0;
        }
      }
      __syncthreads();
    }
    b = be;
  }
}

// get(w, e, n): window w's candidates of slots e .. e+3 (INT_MAX = nothing;
// INT_MAX at or past n).
struct PlainCand {
  const int* __restrict__ cand;  // [n_windows, ep]
  long long ep;
  bool vec;
  template <bool kStream>
  __device__ __forceinline__ int4 get(int w, long long e, long long n) const {
    return load4<kStream>(cand + w * ep, e, n, vec, INT_MAX);
  }
};

struct RelaxCand {
  const int* __restrict__ arr;
  const int* __restrict__ ts;
  const int* __restrict__ te;
  const int* __restrict__ valid;
  int ta;
  int tb;
  int strict;
  bool vec;
  __device__ __forceinline__ int one(int a, int s, int t, int ok) const {
    const bool follows = strict ? (a < s) : (a <= s);
    return ok != 0 && s >= ta && t <= tb && follows && a < INT_MAX ? t : INT_MAX;
  }
  template <bool kStream>
  __device__ __forceinline__ int4 get(int, long long e, long long n) const {
    const int4 a = load4<kStream>(arr, e, n, vec, INT_MAX);
    const int4 s = load4<kStream>(ts, e, n, vec, 0), t = load4<kStream>(te, e, n, vec, 0);
    const int4 v = load4<kStream>(valid, e, n, vec, 0);
    return make_int4(one(a.x, s.x, t.x, v.x), one(a.y, s.y, t.y, v.y),
                     one(a.z, s.z, t.z, v.z), one(a.w, s.w, t.w, v.w));
  }
};

template <int kThreads, int kRounds, int kMinCtas, bool kOne>
__global__ void __launch_bounds__(kThreads, kMinCtas)
segment_min_tiles_kernel(const int* __restrict__ dst_local, const int* __restrict__ cand,
                         const int* __restrict__ block_tile,
                         const int* __restrict__ tile_start, int* __restrict__ out,
                         unsigned* __restrict__ scratch, int* __restrict__ counter,
                         int n_blocks, int n_tiles, int tile_v, int block_e,
                         int n_windows, int wc, int vec) {
  const PlainCand c{cand, static_cast<long long>(n_blocks) * block_e, vec != 0};
  tile_min_cta<kThreads, kRounds, kOne>(dst_local, block_tile, tile_start, out, scratch,
                                        counter, n_blocks, n_tiles, tile_v, block_e,
                                        n_windows, wc, vec != 0, c);
}

__global__ void __launch_bounds__(kRelaxThreads, kRelaxMinCtas)
temporal_relax_min_tiles_kernel(const int* __restrict__ dst_local,
                                const int* __restrict__ arr, const int* __restrict__ ts,
                                const int* __restrict__ te, const int* __restrict__ valid,
                                const int* __restrict__ block_tile,
                                const int* __restrict__ tile_start, int* __restrict__ out,
                                unsigned* __restrict__ scratch, int* __restrict__ counter,
                                int n_blocks, int n_tiles, int tile_v, int block_e,
                                int ta, int tb, int strict, int vec) {
  const RelaxCand c{arr, ts, te, valid, ta, tb, strict, vec != 0};
  tile_min_cta<kRelaxThreads, kRelaxRounds, true>(dst_local, block_tile, tile_start, out,
                                                  scratch, counter, n_blocks, n_tiles, tile_v,
                                                  block_e, 1, 1, vec != 0, c);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

unsigned grid_x(int n_blocks, int block_e, int threads, int rounds) {
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const long long slots = 4LL * threads * rounds;
  return static_cast<unsigned>((ep + slots - 1) / slots);
}

// Shared memory a CTA of wc windows takes: the accumulators and the
// empty-tile flags.  Above the 48 KB a launch gets by default the kernel
// must be allowed it first (up to 227 KB).
size_t smem_bytes(int wc, int tile_v) {
  return (static_cast<size_t>(wc) * tile_v + kMaxWarps) * sizeof(int);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace

// Plain C interface (loaded with ctypes).  tile_start [n_tiles + 1] holds
// each tile's first block (kernels/ops.py::tile_starts).  out is written
// whole by the kernel; scratch (as out, unsigned) and counter
// [ceil(n_windows / wc), n_tiles] must be zero and are left zero.  Each
// returns the CUDA error of the launch (0 when it was accepted).
extern "C" int segment_min_tiles_launch(const int* dst_local, const int* cand,
                                        const int* block_tile, const int* tile_start,
                                        int* out, unsigned* scratch, int* counter,
                                        int n_blocks, int n_tiles, int tile_v, int block_e,
                                        int n_windows, int wc, void* stream) {
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const int vec = ep % 4 == 0 && aligned16(dst_local) && aligned16(cand);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(wc, tile_v);
  static size_t allowed_one = 48 * 1024, allowed_many = 48 * 1024;
  if (n_windows == 1) {
    const auto kernel = segment_min_tiles_kernel<kOneThreads, kOneRounds, kOneMinCtas, true>;
    const cudaError_t err = allow_smem(kernel, smem, allowed_one);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid_x(n_blocks, block_e, kOneThreads, kOneRounds), kOneThreads, smem, st>>>(
        dst_local, cand, block_tile, tile_start, out, scratch, counter, n_blocks, n_tiles,
        tile_v, block_e, 1, 1, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = segment_min_tiles_kernel<kManyThreads, kManyRounds, kManyMinCtas, false>;
  const cudaError_t err = allow_smem(kernel, smem, allowed_many);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x(n_blocks, block_e, kManyThreads, kManyRounds),
                  (n_windows + wc - 1) / wc);
  kernel<<<grid, kManyThreads, smem, st>>>(dst_local, cand, block_tile, tile_start, out,
                                          scratch, counter, n_blocks, n_tiles, tile_v, block_e,
                                          n_windows, wc, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int temporal_relax_min_tiles_launch(
    const int* dst_local, const int* arr, const int* ts, const int* te, const int* valid,
    const int* block_tile, const int* tile_start, int* out, unsigned* scratch, int* counter,
    int n_blocks, int n_tiles, int tile_v, int block_e, int ta, int tb, int strict,
    void* stream) {
  const long long ep = static_cast<long long>(n_blocks) * block_e;
  const int vec = ep % 4 == 0 && aligned16(dst_local) && aligned16(arr) &&
                  aligned16(ts) && aligned16(te) && aligned16(valid);
  const size_t smem = smem_bytes(1, tile_v);
  static size_t allowed = 48 * 1024;
  const cudaError_t err = allow_smem(temporal_relax_min_tiles_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  temporal_relax_min_tiles_kernel<<<grid_x(n_blocks, block_e, kRelaxThreads, kRelaxRounds),
                                    kRelaxThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dst_local, arr, ts, te, valid, block_tile, tile_start, out, scratch, counter, n_blocks,
      n_tiles, tile_v, block_e, ta, tb, strict, vec);
  return static_cast<int>(cudaGetLastError());
}
