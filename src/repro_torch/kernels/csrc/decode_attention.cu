// Flash-decode attention for Hopper (sm_90a): one query token per row over a
// KV cache with per-row lengths, the attention of every layer of every
// decode step of LM serving (models/transformer.py::decode_step).
//
// decode_attention_kernel replaces the Pallas kernel
//   src/repro/kernels/decode_attention.py::decode_attention_pallas.
//
// What it computes: for row b, KV head h and query head g of its GQA group
// (query head h * G + g of q [B, H, Dh]), with n = min(cache_len[b], S):
//   s_i = (q * scale) . k[b, i, h, :]  for i < n,  scale = 1 / sqrt(Dh)
//   o   = sum_i exp(s_i - m) v[b, i, h, :] / max(sum_i exp(s_i - m), 1e-30)
// in float32, read from float32 or bfloat16 caches [B, S, KH, Dh] and written
// in q's type.  A row with n = 0 gives zeros.
//
// Bound: memory bytes.  Each valid K and V row is read once (Dh elements of
// each, per KV head), q is read and o written once: at the serving shape of
// phi4-mini (B = 8, KH = 8, G = 3, Dh = 128, S = 2048, bfloat16) and a mean
// length of S / 2 that is 33.6 MB, 10 us at 3.35 TB/s, against about 0.1
// GFLOP of work (about 1.5 FMA per byte), far below the CUDA cores' rate,
// so the tensor cores are not used.
//
// Design.  The TPU grid (B, KH, S blocks) walks a row's cache blocks in
// order and carries the online-softmax state (m, l, acc) in VMEM scratch.
// Here one launch does everything:
// - Work sized to the lengths, on the device.  The grid is persistent (as
//   many CTAs as fit on the SMs, 3 per SM at the serving shape).  Every CTA
//   reads the B lengths and picks the positions per work item (`chunk`):
//   the least multiple of kTile, at least kMinChunk and with at most
//   kMaxSplit splits per row, at which the (row, split, KV head) items that
//   hold positions number no more than the CTAs, so each CTA has one item
//   and no CTA a second one that would set the kernel's time.  It lays the
//   items out in shared memory and walks items blockIdx.x, blockIdx.x +
//   gridDim.x, ...  A row of length 0 is one item per KV head that writes
//   zeros.
// - One pass per item.  Tiles of kTile positions of K and V are staged into
//   shared memory with cp.async (16 bytes a lane) in a ring of kStages, so
//   two tiles' loads are in flight while one is computed, and the softmax
//   runs online across the tiles (m, l per query head in the registers of
//   the warp that scores it, a correction factor per tile for the PV sums);
//   two barriers a tile.  Scores: lane i of warp w takes position i of the
//   tile for query head w (and w + 4): a whole dot product per lane from
//   shared memory (rows padded by 16 bytes, so the lanes hit distinct
//   banks), no shuffles.  PV: each thread keeps two columns of the G output
//   rows for a share of the positions.  G is a template parameter: no work
//   for absent heads.
// - The split combine in the same launch.  An item that is not its row's
//   only split writes its partial (acc, m, l) per query head, and the last
//   CTA of a (row, KV head) to finish (a __threadfence and an atomicAdd on
//   a per-(row, KV head) counter) combines the partials in split order (one
//   lane per split for the weights, then every thread's loads of the
//   partial sums in flight at once) and resets the counter to 0 for the
//   next call on the stream.  A row of one split writes its output directly.
// Rows not 16-byte aligned use the VEC = 1 variant: the same pipeline with
// element copies into shared memory instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // positions per pipeline stage (one per lane)
constexpr int kStages = 3;      // ring depth: two tiles in flight while one is computed
constexpr int kMinChunk = 64;   // fewest positions per work item
constexpr int kMaxSplit = 32;   // most splits per row: one warp lane each
constexpr int kMaxGroup = 8;    // query heads per KV head
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_ptr)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory row stride of a staged K or V row, in elements: 16 bytes of
// padding for vector rows, one element otherwise.
template <typename T, int VEC>
__host__ __device__ constexpr int row_stride(int Dh) {
  return Dh + (VEC > 1 ? VEC : 1);
}
// columns per thread in the PV sums
template <int VEC>
__host__ __device__ constexpr int cols_per_thread() {
  return VEC > 1 ? 2 : 1;
}

// Fewest positions per split at cache length S: at least kMinChunk and
// few enough splits per row for one warp's lanes, a multiple of kTile.
__host__ __device__ constexpr int min_chunk(int S) {
  const int c = (S + kMaxSplit - 1) / kMaxSplit;
  return ((c > kMinChunk ? c : kMinChunk) + kTile - 1) / kTile * kTile;
}

// Byte offsets of the dynamic shared-memory regions.
struct Layout {
  size_t q, p, corr, red, comb, prefix, total;
};
template <typename T, int VEC>
__host__ __device__ Layout smem_layout(int B, int G, int Dh) {
  Layout L;
  const size_t ring = static_cast<size_t>(kStages) * 2 * kTile * row_stride<T, VEC>(Dh) *
                      sizeof(T);
  L.q = (ring + 15) / 16 * 16;                                 // [G][Dh] q * scale
  L.p = L.q + static_cast<size_t>(G) * Dh * sizeof(float);     // [G][kTile] probabilities
  L.corr = L.p + static_cast<size_t>(G) * kTile * sizeof(float);  // [G] corr, [2G] m, l
  const int nc = Dh / cols_per_thread<VEC>();
  const int rsplit = kThreads / nc;                             // position groups of PV
  L.red = L.corr + 3 * static_cast<size_t>(G) * sizeof(float);  // [rsplit][G][Dh]
  L.comb = L.red + static_cast<size_t>(rsplit) * G * Dh * sizeof(float);  // [G][kMaxSplit]
  L.prefix = L.comb + static_cast<size_t>(G) * kMaxSplit * sizeof(float);
  L.total = L.prefix + (static_cast<size_t>(B) + 1) * sizeof(int);
  return L;
}

// dot(q_s[0:Dh], row[0:Dh]) with row in shared memory; four partial sums
// keep the FMA chain short
template <typename T, int VEC>
__device__ __forceinline__ float dot_row(const T* row, const float* qs, int Dh) {
  if constexpr (VEC == 1) {
    float acc = 0.0f;
    for (int d = 0; d < Dh; ++d) acc = fmaf(qs[d], to_float(row[d]), acc);
    return acc;
  } else {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (sizeof(T) == 4) {
#pragma unroll 4
      for (int d = 0; d < Dh; d += 4) {
        const float4 x = *reinterpret_cast<const float4*>(row + d);
        const float4 w = *reinterpret_cast<const float4*>(qs + d);
        a[0] = fmaf(w.x, x.x, a[0]);
        a[1] = fmaf(w.y, x.y, a[1]);
        a[2] = fmaf(w.z, x.z, a[2]);
        a[3] = fmaf(w.w, x.w, a[3]);
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < Dh; d += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + d);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float4 w0 = *reinterpret_cast<const float4*>(qs + d);
        const float4 w1 = *reinterpret_cast<const float4*>(qs + d + 4);
        float2 f = __bfloat1622float2(h[0]);
        a[0] = fmaf(w0.x, f.x, a[0]);
        a[1] = fmaf(w0.y, f.y, a[1]);
        f = __bfloat1622float2(h[1]);
        a[2] = fmaf(w0.z, f.x, a[2]);
        a[3] = fmaf(w0.w, f.y, a[3]);
        f = __bfloat1622float2(h[2]);
        a[0] = fmaf(w1.x, f.x, a[0]);
        a[1] = fmaf(w1.y, f.y, a[1]);
        f = __bfloat1622float2(h[3]);
        a[2] = fmaf(w1.z, f.x, a[2]);
        a[3] = fmaf(w1.w, f.y, a[3]);
      }
    }
    return (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// CPT consecutive elements of a staged row as floats
template <typename T, int CPT>
__device__ __forceinline__ void load_cols(const T* p, float (&x)[CPT]) {
  if constexpr (CPT == 1) {
    x[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  }
}

// Persistent grid.  part[b, h, split, g, :] = (acc[0:Dh], m, l, pad) for rows of
// several splits; counter[b * KH + h] counts finished splits (0 between
// calls).
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cache_len,
                        float* __restrict__ part, int* __restrict__ counter,
                        T* __restrict__ o, int B, int S, int KH, int Dh, int max_split,
                        float scale) {
  constexpr int CPT = cols_per_thread<VEC>();
  constexpr int GW = (G + kWarps - 1) / kWarps;  // query heads scored per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_sum[kWarps];
  __shared__ int ctrl[2];  // chunk, is-last flag
  const Layout L = smem_layout<T, VEC>(B, G, Dh);
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);
  float* ml_s = corr_s + G;
  float* red_s = reinterpret_cast<float*>(smem + L.red);
  float* w_s = reinterpret_cast<float*>(smem + L.comb);
  int* prefix = reinterpret_cast<int*>(smem + L.prefix);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stride = row_stride<T, VEC>(Dh);

  // 1. The positions per item: the smallest multiple of kTile, at least
  //    min_chunk(S), whose items fit the grid once, from the rows' lengths
  //    (kept in prefix[] until step 2 replaces them by the item offsets).
  long long mine = 0;
  for (int b = tid; b < B; b += kThreads) {
    prefix[b] = min(max(cache_len[b], 0), S);
    mine += prefix[b];
  }
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_xor_sync(kFull, mine, off);
  if (lane == 0) warp_sum[warp] = mine;
  __syncthreads();
  if (warp == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    const long long grid = gridDim.x;
    long long c = (total * KH + grid - 1) / grid;
    c = max((c + kTile - 1) / kTile * kTile, static_cast<long long>(min_chunk(S)));
    for (; c < S; c += kTile) {  // uniform across the warp
      long long items = 0;
      for (int b = lane; b < B; b += 32) items += KH * max(1LL, (prefix[b] + c - 1) / c);
      for (int off = 16; off > 0; off >>= 1) items += __shfl_xor_sync(kFull, items, off);
      if (items <= grid) break;
    }
    if (lane == 0) ctrl[0] = static_cast<int>(min(c, static_cast<long long>(S)));
  }
  __syncthreads();
  const int chunk = ctrl[0];

  // 2. The items: row b owns items [prefix[b], prefix[b + 1]), KH per split.
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      int cnt = 0;
      if (b < B) cnt = KH * max(1, (prefix[b] + chunk - 1) / chunk);
      int inc = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += t;
      }
      if (b < B) prefix[b] = carry + inc - cnt;
      carry += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) prefix[B] = carry;
  }
  __syncthreads();
  const int n_items = prefix[B];

  // copy layout: 16-byte piece cp_col of a row, rows cp_row + k * cp_step
  const int cpr = VEC > 1 ? Dh / VEC : 1;
  const int cp_step = kThreads / cpr;
  const int cp_row = tid / cpr, cp_col = (tid - cp_row * cpr) * VEC;
  const bool cp_on = cp_row < cp_step;
  // PV thread layout: column group `col` (CPT columns), position group `r`
  const int nc = Dh / CPT;
  const int rsplit = kThreads / nc;
  const int col = tid % nc, r = tid / nc;
  const bool pv_on = r < rsplit;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int lo = 0, hi = B - 1;  // the last row whose items start at or before `item`
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (prefix[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    const int local = item - prefix[b];
    const int split = local / KH, h = local - split * KH;
    const int n = min(max(cache_len[b], 0), S);
    const int n_split = max(1, (n + chunk - 1) / chunk);
    T* ob = o + (static_cast<long long>(b) * KH + h) * G * Dh;
    __syncthreads();  // the previous item's shared memory is free
    if (n == 0) {
      for (int i = tid; i < G * Dh; i += kThreads) ob[i] = from_float<T>(0.0f);
      continue;
    }
    const int p0 = split * chunk;
    const int cnt = min(chunk, n - p0);
    const int n_tiles = (cnt + kTile - 1) / kTile;
    const long long rs = static_cast<long long>(KH) * Dh;  // between positions
    const long long first = (static_cast<long long>(b) * S + p0) * rs +
                            static_cast<long long>(h) * Dh;
    const T* kb = k + first;
    const T* vb = v + first;
    const T* qb = q + (static_cast<long long>(b) * KH + h) * G * Dh;

    auto issue = [&](int t) {
      if (t < n_tiles) {
        const int rows = min(kTile, cnt - t * kTile);
        T* ks = ring + static_cast<size_t>(t % kStages) * 2 * kTile * stride;
        T* vs = ks + kTile * stride;
        const T* kg = kb + static_cast<long long>(t) * kTile * rs;
        const T* vg = vb + static_cast<long long>(t) * kTile * rs;
        if constexpr (VEC > 1) {
          // thread tid copies piece `cp_col` of rows cp_row, cp_row + cp_step, ...
          if (cp_on) {
            for (int row = cp_row; row < rows; row += cp_step) {
              cp_async16(ks + row * stride + cp_col, kg + row * rs + cp_col);
              cp_async16(vs + row * stride + cp_col, vg + row * rs + cp_col);
            }
          }
        } else {
          for (int i = tid; i < rows * Dh; i += kThreads) {
            const int row = i / Dh, c = i - row * Dh;
            ks[row * stride + c] = kg[row * rs + c];
            vs[row * stride + c] = vg[row * rs + c];
          }
        }
      }
      cp_async_commit();  // an empty group past the last tile keeps the count
    };

    float m[GW], l[GW];
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      m[j] = -CUDART_INF_F;
      l[j] = 0.0f;
    }
    float acc[G][CPT];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[g][e] = 0.0f;
    }

#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
    // q while the first tiles are in flight
    for (int i = tid; i < G * Dh; i += kThreads) q_s[i] = to_float(qb[i]) * scale;
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();
      // tile t and q_s visible to every thread, and every thread done with
      // tile t - 1, whose stage the next issue refills
      __syncthreads();
      issue(t + kStages - 1);
      const T* ks = ring + static_cast<size_t>(t % kStages) * 2 * kTile * stride;
      const T* vs = ks + kTile * stride;
      const int rows = min(kTile, cnt - t * kTile);
      // scores and the online softmax, one warp per query head
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        const int g = warp + j * kWarps;
        if (g < G) {
          const float sc = lane < rows ? dot_row<T, VEC>(ks + lane * stride, q_s + g * Dh, Dh)
                                       : -CUDART_INF_F;
          float tmax = sc;
          for (int off = 16; off > 0; off >>= 1) {
            tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, off));
          }
          const float m_new = fmaxf(m[j], tmax);
          const float p = lane < rows ? expf(sc - m_new) : 0.0f;
          p_s[g * kTile + lane] = p;
          float psum = p;
          for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(kFull, psum, off);
          const float corr = m[j] == -CUDART_INF_F ? 0.0f : expf(m[j] - m_new);
          l[j] = fmaf(l[j], corr, psum);
          m[j] = m_new;
          if (lane == 0) corr_s[g] = corr;
        }
      }
      __syncthreads();
      // PV over the tile's valid rows
      if (pv_on) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float c = corr_s[g];
#pragma unroll
          for (int e = 0; e < CPT; ++e) acc[g][e] *= c;
        }
#pragma unroll 4
        for (int i = r; i < rows; i += rsplit) {
          float x[CPT];
          load_cols<T, CPT>(vs + i * stride + col * CPT, x);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = p_s[g * kTile + i];
#pragma unroll
            for (int e = 0; e < CPT; ++e) acc[g][e] = fmaf(p, x[e], acc[g][e]);
          }
        }
      }
    }

    // the position groups' PV sums meet in shared memory
    if (pv_on) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < CPT; ++e) red_s[(r * G + g) * Dh + col * CPT + e] = acc[g][e];
      }
    }
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const int g = warp + j * kWarps;
      if (g < G && lane == 0) {
        ml_s[2 * g] = m[j];
        ml_s[2 * g + 1] = l[j];
      }
    }
    __syncthreads();
    if (n_split == 1) {
      for (int i = tid; i < G * Dh; i += kThreads) {
        const int g = i / Dh, d = i - g * Dh;
        float s = 0.0f;
        for (int w = 0; w < rsplit; ++w) s += red_s[(w * G + g) * Dh + d];
        ob[i] = from_float<T>(s / fmaxf(ml_s[2 * g + 1], 1e-30f));
      }
      continue;
    }
    const int rec = Dh + 4;  // acc[Dh], m, l, 2 floats of padding: 16-byte records
    float* recs = part + (static_cast<long long>(b) * KH + h) * max_split * G * rec;
    float* mine_rec = recs + static_cast<long long>(split) * G * rec;
    for (int i = tid; i < G * Dh; i += kThreads) {
      const int g = i / Dh, d = i - g * Dh;
      float s = 0.0f;
      for (int w = 0; w < rsplit; ++w) s += red_s[(w * G + g) * Dh + d];
      mine_rec[g * rec + d] = s;
    }
    if (tid < G) {
      mine_rec[tid * rec + Dh] = ml_s[2 * tid];
      mine_rec[tid * rec + Dh + 1] = ml_s[2 * tid + 1];
    }
    __threadfence();  // the partial is visible before the count says so
    __syncthreads();
    if (tid == 0) {
      ctrl[1] = atomicAdd(counter + b * KH + h, 1) == n_split - 1;
    }
    __syncthreads();
    if (ctrl[1]) {  // the last split of (b, h) to finish combines them all
      __threadfence();
      // one warp per query head, one lane per split: the splits' weights
      // exp(m_s - m) / sum_s exp(m_s - m) l_s
#pragma unroll
      for (int j = 0; j < GW; ++j) {
        const int g = warp + j * kWarps;
        if (g < G) {
          const bool on = lane < n_split;
          const float* ps = recs + (static_cast<long long>(lane) * G + g) * rec + Dh;
          const float ms = on ? __ldcg(ps) : -CUDART_INF_F;
          const float ls = on ? __ldcg(ps + 1) : 0.0f;
          float mx = ms;
          for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          const float w = on ? expf(ms - mx) : 0.0f;
          float lsum = w * ls;
          for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(kFull, lsum, off);
          w_s[g * kMaxSplit + lane] = w / fmaxf(lsum, 1e-30f);
        }
      }
      __syncthreads();
      // the weighted sum of the splits' PV sums: every load of a thread in
      // flight at once (up to 8), four columns a load where rows allow
      constexpr int CW = VEC > 1 ? 4 : 1;
      for (int i = tid * CW; i < G * Dh; i += kThreads * CW) {
        const int g = i / Dh, d = i - g * Dh;
        const float* pa = recs + g * rec + d;
        const float* wg = w_s + g * kMaxSplit;
        float a[CW] = {};
#pragma unroll 8
        for (int sp = 0; sp < n_split; ++sp) {
          const float w = wg[sp];
          if constexpr (CW == 4) {
            const float4 x = __ldcg(reinterpret_cast<const float4*>(pa + sp * G * rec));
            a[0] = fmaf(w, x.x, a[0]);
            a[1] = fmaf(w, x.y, a[1]);
            a[2] = fmaf(w, x.z, a[2]);
            a[3] = fmaf(w, x.w, a[3]);
          } else {
            a[0] = fmaf(w, __ldcg(pa + sp * G * rec), a[0]);
          }
        }
#pragma unroll
        for (int e = 0; e < CW; ++e) ob[i + e] = from_float<T>(a[e]);
      }
      if (tid == 0) counter[b * KH + h] = 0;
    }
  }
}

// Blocks per SM of one kernel instance at `smem` bytes, cached per device
// (the last query's answer).
struct Occupancy {
  size_t smem = 0;
  int blocks = 0;
};

template <typename T, int VEC, int G>
int launch(const void* q, const void* k, const void* v, const int* cache_len, float* part,
           int* counter, void* o, int B, int S, int KH, int Dh, int max_split, float scale,
           cudaStream_t stream) {
  if (Dh % VEC != 0 || (VEC > 1 && Dh % 2 != 0) || Dh / cols_per_thread<VEC>() > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_layout<T, VEC>(B, G, Dh).total;
  auto kernel = decode_attention_kernel<T, VEC, G>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static Occupancy occ[kMaxDevices];
  static int n_sm[kMaxDevices];
  if (occ[dev].smem != smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    err = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    occ[dev].blocks = blocks;
    occ[dev].smem = smem;
  }
  const long long max_items = static_cast<long long>(B) * KH * max_split;
  const int grid = static_cast<int>(
      max_items < static_cast<long long>(n_sm[dev]) * occ[dev].blocks
          ? max_items
          : static_cast<long long>(n_sm[dev]) * occ[dev].blocks);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      cache_len, part, counter, static_cast<T*>(o), B, S, KH, Dh, max_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_group(const void* q, const void* k, const void* v, const int* cache_len,
                 float* part, int* counter, void* o, int B, int S, int KH, int G, int Dh,
                 int max_split, float scale, cudaStream_t st) {
#define K4_CASE(g)                                                                    \
  case g:                                                                             \
    return launch<T, VEC, g>(q, k, v, cache_len, part, counter, o, B, S, KH, Dh,      \
                             max_split, scale, st);
  switch (G) {
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4) K4_CASE(5) K4_CASE(6) K4_CASE(7) K4_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K4_CASE
}

}  // namespace

// Plain C interface (loaded with ctypes).  q and o are [B, KH * G, Dh], the
// caches [B, S, KH, Dh], all contiguous and of one type (dtype 0: float32,
// 1: bfloat16); `part` is float32 scratch of B * KH * max_split * G *
// (Dh + 4) elements with max_split = ceil(S / c), c = max(64, ceil(S / 32))
// rounded up to a multiple of 32 (at most 32 splits); `counter` is int32
// scratch of B * KH elements, zero before the first call and left zero by
// every call (reuse it only on one stream); `vec` is 1, or 16 bytes' worth
// of elements when every row is 16-byte aligned.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape the kernel does not
// take (including more rows than its shared memory holds).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* cache_len, float* part, int* counter,
                                       void* o, int B, int S, int KH, int G, int Dh,
                                       int max_split, float scale, int dtype, int vec,
                                       void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || G > kMaxGroup || Dh <= 0 ||
      max_split != (S + min_chunk(S) - 1) / min_chunk(S) ||
      static_cast<long long>(B) * KH * max_split > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_cap = 227 * 1024;
  if (dtype == 0) {
    if (vec == 4 && smem_layout<float, 4>(B, G, Dh).total <= smem_cap) {
      return launch_group<float, 4>(q, k, v, cache_len, part, counter, o, B, S, KH, G, Dh,
                                    max_split, scale, st);
    }
    if (vec == 1 && smem_layout<float, 1>(B, G, Dh).total <= smem_cap) {
      return launch_group<float, 1>(q, k, v, cache_len, part, counter, o, B, S, KH, G, Dh,
                                    max_split, scale, st);
    }
  } else if (dtype == 1) {
    if (vec == 8 && smem_layout<__nv_bfloat16, 8>(B, G, Dh).total <= smem_cap) {
      return launch_group<__nv_bfloat16, 8>(q, k, v, cache_len, part, counter, o, B, S, KH,
                                            G, Dh, max_split, scale, st);
    }
    if (vec == 1 && smem_layout<__nv_bfloat16, 1>(B, G, Dh).total <= smem_cap) {
      return launch_group<__nv_bfloat16, 1>(q, k, v, cache_len, part, counter, o, B, S, KH,
                                            G, Dh, max_split, scale, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
