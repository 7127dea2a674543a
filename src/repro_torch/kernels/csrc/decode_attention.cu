// Flash-decode attention for Hopper (sm_90a): one query token per row over a
// KV cache with per-row lengths, the attention of every layer of every
// decode step of LM serving (models/transformer.py::decode_step).
//
// decode_partial_kernel + decode_combine_kernel replace the Pallas kernel
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
// GFLOP of work, far below the card's float32 rate.
//
// Design.  The TPU grid (B, KH, S blocks) walks a row's cache blocks in
// order and carries the online-softmax state (m, l, acc) in VMEM scratch
// from one block to the next.  Here blocks of the grid run in no order, and
// (B, KH) alone is only 64 CTAs at the serving shape for 132 SMs, so the
// cache axis is split instead: CTA (split, h, b) takes positions
// [split * chunk, split * chunk + chunk) of its row, stops at the row's
// length instead of masking (a short row's later CTAs return at once), and
// writes its partial state (m, l, unnormalised acc) per query head; a second
// kernel, one CTA per (h, b), combines the partials.  Inside a CTA a K or V
// row is read by Dh / VEC neighbouring lanes with 16-byte loads (VEC = 4
// floats or 8 bfloat16), several rows per warp and kUnroll rows per lane in
// flight; each lane keeps its columns of the G scaled query rows and its PV
// sums in registers, the chunk's scores and probabilities sit in shared
// memory, and the PV sums meet in a shared-memory reduction over the warps.
// The products run on the CUDA cores, not the tensor cores: at one query
// token per KV head (G rows) the work is a matrix-vector product.  The
// positions per CTA (`chunk`) are the wrapper's CHUNK.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads per KV head kept in registers
constexpr int kUnroll = 4;    // rows per lane in flight
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

// VEC consecutive elements at p (16-byte aligned when VEC > 1) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "float rows load 4 at a time");
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
    static_assert(VEC == 8, "bfloat16 rows load 8 at a time");
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// grid = (n_split, KH, B).  part[b, h, split, g, :] = (m, l, acc[0:Dh]).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ cache_len,
                      float* __restrict__ part, int S, int KH, int G, int Dh,
                      int chunk, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;               // [G][Dh]   q * scale
  float* p_s = q_s + G * Dh;       // [G][chunk] scores, then exp(s - m)
  float* r_s = p_s + G * chunk;    // [kWarps][G][Dh] per-warp PV sums

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(cache_len[b], 0), S);
  const int p0 = split * chunk;
  const int n = min(chunk, len - p0);  // positions of this CTA
  const int rec = Dh + 2;
  float* out = part + ((static_cast<long long>(b) * KH + h) * gridDim.x + split) * G * rec;
  if (n <= 0) {
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      out[g * rec] = -CUDART_INF_F;
      out[g * rec + 1] = 0.0f;
    }
    return;
  }
  const long long row_stride = static_cast<long long>(KH) * Dh;  // between positions
  const long long first = (static_cast<long long>(b) * S + p0) * row_stride +
                          static_cast<long long>(h) * Dh;
  const T* kb = k + first;
  const T* vb = v + first;
  const T* qb = q + (static_cast<long long>(b) * KH + h) * G * Dh;
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) q_s[i] = to_float(qb[i]) * scale;
  __syncthreads();

  const int nv = Dh / VEC;  // vectors per row, at most 32
  int lpr = 1;              // lanes per row: a power of two >= nv
  while (lpr < nv) lpr <<= 1;
  const int rpw = 32 / lpr;       // rows per warp and pass
  const int sub = lane & (lpr - 1);  // this lane's vector of the row
  const int rw = lane / lpr;         // this lane's row of the pass
  const bool lane_on = sub < nv;
  const int step = kWarps * rpw;     // rows of one pass over the CTA
  float qf[kMaxGroup][VEC];          // this lane's columns of the G query rows
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qf[g][e] = (g < G && lane_on) ? q_s[g * Dh + sub * VEC + e] : 0.0f;
    }
  }

  // Scores.  The loop bound is uniform across a warp, so every lane joins
  // the shuffles.
  for (int i0 = 0; i0 < n; i0 += step * kUnroll) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step + warp * rpw + rw;
      if (i < n && lane_on) {
        load_vec<T, VEC>(kb + i * row_stride + sub * VEC, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[u][e] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step + warp * rpw + rw;
      float acc[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        acc[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g] = fmaf(qf[g][e], x[u][e], acc[g]);
        if (g < G) {
          for (int off = lpr >> 1; off > 0; off >>= 1) {
            acc[g] += __shfl_xor_sync(kFull, acc[g], off);
          }
        }
      }
      if (i < n && sub == 0) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) p_s[g * chunk + i] = acc[g];
        }
      }
    }
  }
  __syncthreads();

  // Softmax over the chunk, one warp per query head: m, exp(s - m), l.
  for (int g = warp; g < G; g += kWarps) {
    float* sg = p_s + g * chunk;
    float m = -CUDART_INF_F;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sg[i]);
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    float l = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sg[i] - m);
      sg[i] = p;
      l += p;
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
    if (lane == 0) {
      out[g * rec] = m;
      out[g * rec + 1] = l;
    }
  }
  __syncthreads();

  // PV: each lane sums its VEC columns over its rows, for every query head.
  float acc[kMaxGroup][VEC];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  }
  for (int i0 = 0; i0 < n; i0 += step * kUnroll) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step + warp * rpw + rw;
      if (i < n && lane_on) {
        load_vec<T, VEC>(vb + i * row_stride + sub * VEC, x[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step + warp * rpw + rw;
      if (i < n && lane_on) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float p = p_s[g * chunk + i];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, x[u][e], acc[g][e]);
          }
        }
      }
    }
  }
  // the rows of a warp, then the warps
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        for (int off = lpr; off < 32; off <<= 1) {
          acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
        }
      }
    }
  }
  if (rw == 0 && lane_on) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          r_s[(warp * G + g) * Dh + sub * VEC + e] = acc[g][e];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * Dh; idx += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += r_s[w * G * Dh + idx];
    const int g = idx / Dh;
    out[g * rec + 2 + (idx - g * Dh)] = s;
  }
}

// grid = (KH, B).  o[b, h * G + g, :] = the combined softmax of the splits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o, int KH,
                      int G, int Dh, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int rec = Dh + 2;
  const long long stride = static_cast<long long>(G) * rec;  // between splits
  const float* pb = part + (static_cast<long long>(b) * KH + h) * n_split * stride;
  T* ob = o + (static_cast<long long>(b) * KH + h) * G * Dh;
  for (int idx = threadIdx.x; idx < G * Dh; idx += blockDim.x) {
    const int g = idx / Dh;
    const float* pg = pb + g * rec;
    float m = -CUDART_INF_F;
    for (int s = 0; s < n_split; ++s) m = fmaxf(m, pg[s * stride]);
    float l = 0.0f, acc = 0.0f;
    if (m > -CUDART_INF_F) {
      for (int s = 0; s < n_split; ++s) {
        const float ms = pg[s * stride];
        if (ms > -CUDART_INF_F) {
          const float w = expf(ms - m);
          l = fmaf(w, pg[s * stride + 1], l);
          acc = fmaf(w, pg[s * stride + 2 + (idx - g * Dh)], acc);
        }
      }
    }
    ob[idx] = from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int VEC>
int launch(const void* q, const void* k, const void* v, const int* cache_len,
           float* part, void* o, int B, int S, int KH, int G, int Dh, int chunk,
           float scale, cudaStream_t stream) {
  if (Dh % VEC != 0 || Dh / VEC > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int n_split = (S + chunk - 1) / chunk;
  const size_t smem =
      static_cast<size_t>(G * Dh + G * chunk + kWarps * G * Dh) * sizeof(float);
  auto kernel = decode_partial_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(n_split, KH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      cache_len, part, S, KH, G, Dh, chunk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(KH, B), kThreads, 0, stream>>>(
      part, static_cast<T*>(o), KH, G, Dh, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  q and o are [B, KH * G, Dh], the
// caches [B, S, KH, Dh], all contiguous and of one type (dtype 0: float32,
// 1: bfloat16); `part` is float32 scratch of B * KH * ceil(S / chunk) * G *
// (Dh + 2) elements; `vec` is 1, or 16 bytes' worth of elements when every
// row is 16-byte aligned.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* cache_len, float* part, void* o,
                                       int B, int S, int KH, int G, int Dh, int chunk,
                                       float scale, int dtype, int vec, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || G <= 0 || G > kMaxGroup || Dh <= 0 ||
      chunk <= 0 || B > 65535 || KH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec == 4) {
      return launch<float, 4>(q, k, v, cache_len, part, o, B, S, KH, G, Dh, chunk, scale, st);
    }
    if (vec == 1) {
      return launch<float, 1>(q, k, v, cache_len, part, o, B, S, KH, G, Dh, chunk, scale, st);
    }
  } else if (dtype == 1) {
    if (vec == 8) {
      return launch<__nv_bfloat16, 8>(q, k, v, cache_len, part, o, B, S, KH, G, Dh,
                                      chunk, scale, st);
    }
    if (vec == 1) {
      return launch<__nv_bfloat16, 1>(q, k, v, cache_len, part, o, B, S, KH, G, Dh,
                                      chunk, scale, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
