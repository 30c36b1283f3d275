// One-token GQA decode attends for Hopper (sm_90a): the ring attend of the
// sliding-window layers and the extent attend of the full-attention layers.
//
// Replaces the TPU kernels repro/kernels/swa_attention.py::
//   ring_decode_attend_pallas   (body _ring_decode_kernel)
//   extent_decode_attend_pallas (body _extent_decode_kernel)
// which share the attend body _decode_attend and the mask _window_bias.
// Here both kernels are one template over RING, sharing one device body.
//
// For each row b (its own position pos[b]) and each kv head, over L keys:
//   ring:   L = W slots, slot s holds position pos - floormod(pos - s, W)
//           (negative = never written, masked);
//   extent: L = k_ext, key s holds position s, masked beyond pos + 1.
// Both apply the window mask (window 0 = full), then the reference's exact
// op sequence: f32 score = (q.k) * scale, max-subtract, exp, divide after
// the sum, p rounded to q's dtype, then p.V accumulated in f32, written in
// q's dtype.
//
// Design. Each (row, kv head) is one cluster of kCluster = 8 thread blocks
// (Hopper's thread block clusters); block r of the cluster owns the r-th
// eighth of the keys. Every block holds the G query heads of its kv head,
// so each K and V element is read once, by one block.
//   1. q (G x D) goes to shared memory as f32.
//   2. Scores: one thread per key of the block's share. It reads the key's
//      D elements (4-element vectors where D and the pointers allow, eight
//      loads in flight) and forms all G dots against q, broadcast from
//      shared memory. Masked keys are not read; their score is -1e30,
//      which exp() turns into an exact 0, as the additive bias does in the
//      reference (the current token is always visible, so a row is never
//      fully masked).
//   3. Softmax without an online rescale: each block's per-head maxima go
//      to the cluster through distributed shared memory, every block takes
//      the max of all eight, forms exp(s - m) for its keys and its partial
//      sums, and every block adds the eight partial sums in rank order, so
//      all hold the same sum. Then p = e / sum, rounded to q's dtype: the
//      reference's max-subtract, divide-after-sum softmax, the full sum
//      taken in another order.
//   4. p.V: threads over (4-element vector of d, key group); each thread
//      sums p * v over its keys (skipping masked ones) with eight rows'
//      loads in flight; the key groups, then the cluster's eight blocks
//      (in rank order, through distributed shared memory), are summed.
//
// Bound on the H100: the function must read the visible keys' K and V,
// 2 * L_visible * KV * D elements a row, and q; it writes B * KV * G * D.
// At Hymba's decode shape (B = 4, KV = 5, G = 5, D = 64, f32) the ring
// reads ~10.5 MB (3.1 us at 3.35 TB/s) and the extent at k_ext = 2048
// ~21 MB (6.3 us) if every key is visible: memory-bound, ~2 flops a byte.
// One block per (row, kv head) ran only B * KV = 20 blocks and was bound
// by the memory latency each SM could hide; clusters of eight put
// 8 * B * KV blocks on the card.
//
// Limits the wrapper enforces: D <= 256, G <= 16, shared memory
// (G*D + G*ceil(L/8) + groups*G*D + 2*G floats, groups = 256 / (D / 4)
// with vector loads) <= 227 KB.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Launches go on the caller's stream; each entry returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks per (row, kv head)
constexpr int kMaxG = 16;
constexpr int kChunk = 8;    // 4-element K loads in flight per thread
constexpr int kUnroll = 8;   // V rows in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p is cast to q's dtype before p.V, as the reference does
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Four consecutive elements as f32 (one 16-byte load for f32, 8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// VW consecutive elements as f32: one vector load when VW == 4.
template <int VW, typename T>
__device__ __forceinline__ void load_vw(const T* p, float (&out)[VW]) {
  if constexpr (VW == 4) {
    const float4 v = load4(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    out[0] = to_f32(p[0]);
  }
}

// Absolute position of key s, and whether row position p may attend to it.
template <bool RING>
__device__ __forceinline__ bool visible(int p, int s, int W, int w_eff) {
  // C's % truncates toward zero; the reference's mod is a floor mod
  const int kpos = RING ? p - (((p - s) % W) + W) % W : s;
  return p >= kpos && p - kpos < w_eff && kpos >= 0;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Grid: B * KV clusters of kCluster blocks of kThreads. k/v: key s of row
// b, head kv at k + b * batch_stride + (s * KV + kv) * D.
template <typename QT, typename KT, bool RING, bool VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_attend_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                     const KT* __restrict__ v, const int* __restrict__ pos,
                     QT* __restrict__ out, int KV, int G, int D, int L,
                     long long batch_stride, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int VW = VEC ? 4 : 1;         // dims a thread owns in p.V
  const int lanes = D / VW;
  const int groups = kThreads / lanes;    // key groups in the p.V pass
  const int grp = threadIdx.x / lanes, ln = threadIdx.x % lanes;
  const int per = (L + kCluster - 1) / kCluster;   // keys a block owns
  const int c0 = rank * per;
  const int n = max(0, min(L, c0 + per) - c0);
  float* qs = smem;                       // G * D
  float* sc = qs + G * D;                 // G * per: scores, then p
  float* red = sc + G * per;              // groups * G * D
  float* stat = red + groups * G * D;     // G maxima, then G partial sums

  const int head_id = blockIdx.x / kCluster;
  const int b = head_id / KV, kv = head_id % KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p = pos[b];
  const int w_eff = window == 0 ? (1 << 30) : window;
  const size_t head = static_cast<size_t>(head_id);
  const KT* kb = k + b * batch_stride + static_cast<size_t>(kv) * D;
  const KT* vb = v + b * batch_stride + static_cast<size_t>(kv) * D;
  const size_t kstride = static_cast<size_t>(KV) * D;

  const QT* qb = q + head * G * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]);
  __syncthreads();

  // 2. scores, one thread per key of this block's share
  for (int j = tid; j < n; j += kThreads) {
    const int s = c0 + j;
    if (!visible<RING>(p, s, L, w_eff)) {
      for (int g = 0; g < G; ++g) sc[g * per + j] = kNegInf;
      continue;
    }
    const KT* krow = kb + s * kstride;
    float acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
    if constexpr (VEC) {
      // kChunk 4-element loads issued before any is used
      for (int d0 = 0; d0 < D; d0 += 4 * kChunk) {
        float4 kd[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c)
          if (d0 + 4 * c < D) kd[c] = load4(krow + d0 + 4 * c);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (d0 + 4 * c >= D) break;
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4 qd = *reinterpret_cast<const float4*>(
                  qs + g * D + d0 + 4 * c);
              acc[g] += qd.x * kd[c].x + qd.y * kd[c].y + qd.z * kd[c].z +
                        qd.w * kd[c].w;
            }
          }
        }
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float kd = to_f32(krow[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += qs[g * D + d] * kd;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) sc[g * per + j] = acc[g] * scale;
  }
  __syncthreads();

  // 3. softmax over the cluster, warp g owning head g
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sc[g * per + j]);
    m = warp_max(m);
    if (lane == 0) stat[g] = m;
  }
  cluster.sync();
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int r = 0; r < kCluster; ++r)
      m = fmaxf(m, cluster.map_shared_rank(stat, r)[g]);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sc[g * per + j] - m);
      sc[g * per + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) stat[G + g] = sum;
  }
  cluster.sync();
  for (int g = warp; g < G; g += kWarps) {
    float sum = 0.f;
    for (int r = 0; r < kCluster; ++r)
      sum += cluster.map_shared_rank(stat, r)[G + g];
    for (int j = lane; j < n; j += 32)
      sc[g * per + j] = round_to<QT>(sc[g * per + j] / sum);
  }
  __syncthreads();

  // 4. p.V: thread (grp, ln) owns VW consecutive dims and sums keys
  // grp, grp + groups, ... of this block's share; kUnroll rows' loads are
  // issued before any is used, so each thread keeps several in flight
  if (grp < groups) {
    float acc[kMaxG][VW];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[g][i] = 0.f;
    for (int j0 = grp; j0 < n; j0 += groups * kUnroll) {
      float vv[kUnroll][VW];
      bool vis[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * groups;
        vis[u] = j < n && visible<RING>(p, c0 + j, L, w_eff);
        if (vis[u]) load_vw<VW>(vb + (c0 + j) * kstride + ln * VW, vv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!vis[u]) continue;
        const int j = j0 + u * groups;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float pg = sc[g * per + j];
#pragma unroll
            for (int i = 0; i < VW; ++i) acc[g][i] += pg * vv[u][i];
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
#pragma unroll
        for (int i = 0; i < VW; ++i)
          red[(grp * G + g) * D + ln * VW + i] = acc[g][i];
  }
  __syncthreads();
  // the block's partial, summed over its key groups, into red[0, G*D)
  for (int i = tid; i < G * D; i += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < groups; ++r) acc += red[r * G * D + i];
    red[i] = acc;
  }
  cluster.sync();
  // the cluster's eight partials, in rank order; each block writes a slice
  QT* ob = out + head * G * D;
  for (int i = rank * kThreads + tid; i < G * D; i += kCluster * kThreads) {
    float acc = 0.f;
    for (int r = 0; r < kCluster; ++r)
      acc += cluster.map_shared_rank(red, r)[i];
    ob[i] = from_f32<QT>(acc);
  }
  cluster.sync();   // no block leaves while another still reads its smem
}

size_t smem_bytes(int G, int D, int L, bool vec) {
  const int groups = kThreads / (vec ? D / 4 : D);
  const int per = (L + kCluster - 1) / kCluster;
  return sizeof(float) *
         (static_cast<size_t>(G) * D + static_cast<size_t>(G) * per +
          static_cast<size_t>(groups) * G * D + 2 * static_cast<size_t>(G));
}

template <typename QT, typename KT, bool RING, bool VEC>
int launch_t(const void* q, const void* k, const void* v, const int* pos,
             void* out, int B, int KV, int G, int D, int L,
             long long batch_stride, int window, float scale,
             cudaStream_t stream) {
  auto kern = decode_attend_kernel<QT, KT, RING, VEC>;
  const size_t smem = smem_bytes(G, D, L, VEC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<B * KV * kCluster, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), pos, static_cast<QT*>(out), KV, G, D, L,
      batch_stride, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool RING, bool VEC>
int launch_vec(const void* q, const void* k, const void* v, const int* pos,
               void* out, int B, int KV, int G, int D, int L,
               long long batch_stride, int window, float scale, int q_dtype,
               int kv_dtype, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
#define ARGS q, k, v, pos, out, B, KV, G, D, L, batch_stride, window, scale, st
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_t<float, float, RING, VEC>(ARGS);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_t<float, bf16, RING, VEC>(ARGS);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_t<bf16, float, RING, VEC>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_t<bf16, bf16, RING, VEC>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool RING>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int KV, int G, int D, int L,
           long long batch_stride, int window, float scale, int q_dtype,
           int kv_dtype, int vec, void* stream) {
  if (B <= 0) return 0;
  if (D < 1 || D > kThreads || G < 1 || G > kMaxG || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    return launch_vec<RING, true>(q, k, v, p, out, B, KV, G, D, L,
                                  batch_stride, window, scale, q_dtype,
                                  kv_dtype, st);
  return launch_vec<RING, false>(q, k, v, p, out, B, KV, G, D, L,
                                 batch_stride, window, scale, q_dtype,
                                 kv_dtype, st);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. vec = 1 when D % 4 == 0 and k, v
// are aligned for 4-element vector loads. Returns the launch's cudaError_t.
int ring_decode_attend_fwd(const void* q, const void* k, const void* v,
                           const void* pos, void* out, int B, int W, int KV,
                           int G, int D, int window, float scale,
                           int q_dtype, int kv_dtype, int vec, void* stream) {
  return launch<true>(q, k, v, pos, out, B, KV, G, D, W,
                      static_cast<long long>(W) * KV * D, window, scale,
                      q_dtype, kv_dtype, vec, stream);
}

int extent_decode_attend_fwd(const void* q, const void* k, const void* v,
                             const void* pos, void* out, int B, int S_max,
                             int k_ext, int KV, int G, int D, int window,
                             float scale, int q_dtype, int kv_dtype, int vec,
                             void* stream) {
  return launch<false>(q, k, v, pos, out, B, KV, G, D, k_ext,
                       static_cast<long long>(S_max) * KV * D, window, scale,
                       q_dtype, kv_dtype, vec, stream);
}

const char* decode_attend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
