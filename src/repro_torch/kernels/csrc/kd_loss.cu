// Fused KD loss for Hopper (sm_90a), forward and backward:
//   out[r] = alpha * (logsumexp(s[r]) - s[r, y[r]])
//          + (1 - alpha) * sum_v ((s[r, v] - t[r, v]) * inv_t)^2
//   lse[r] = logsumexp(s[r])                       (for the backward)
//   ds[r, v] = g[r] * (alpha * (exp(s[r, v] - lse[r]) - [v = y[r]])
//                      + (1 - alpha) * 2 (s[r, v] - t[r, v]) / T^2)
//   dt[r, v] = -g[r] * (1 - alpha) * 2 (s[r, v] - t[r, v]) / T^2
// and exactly 0 (out, ds, dt) where valid[r] <= 0, by select: garbage
// logits in masked rows may be read but never reach an output. A null
// valid means every row is live.
//
// Replaces the TPU kernel repro/kernels/kd_loss.py::kd_loss_pallas (its
// body _kernel), which streams vocab tiles through VMEM carrying an online
// (max, sumexp), the gathered gold logit and the running squared error in
// scratch across a sequential grid axis; and the reference's backward
// _rows_bwd (kd_loss.py:164), XLA ops on the saved logits.
//
// Bound on the H100: the forward reads 2*R*V elements of s and t (plus R
// labels and masks) and writes 2R floats, about R*V*8 bytes in f32; the
// backward reads s and t again and writes ds (and dt). At the main path's
// R = 4, V = 400 that is ~13 KB, a few nanoseconds at 3.35 TB/s: the
// launch and the latency of the row's DRAM round trips bound both. So:
//
// - Forward, V <= 1024, 16-byte aligned rows: one warp a row, the row held
//   in registers. The 16-byte loads of s and t, the label and the mask are
//   all issued at once (nothing waits on the mask); the max, then
//   sum exp(s - max), are two warp reductions over registers (no online
//   rescale); the gold logit is gathered by comparing the column with the
//   label.
// - Forward otherwise (V > 1024, or rows not aligned for the vectors): the
//   strided online-softmax kernel, one warp a row (V <= 1024) or one
//   256-thread block a row.
// - Backward: one kernel, the forward's row layout, one pass: s and t read
//   once (16-byte vectors where aligned, all of a trip's loads issued
//   before its first store), ds and dt written once. A null dt is neither
//   computed nor written (the teacher needs no gradient).
//
// s and t are read in their own dtype (f32 or bf16); all arithmetic is
// f32; ds and dt are written in the logits' dtype.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream and the return value is
// cudaGetLastError() right after it (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWarpBlock = 4;

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

template <int BYTES> struct ChunkOf;
template <> struct ChunkOf<16> { using type = uint4; };
template <> struct ChunkOf<4> { using type = unsigned int; };
template <> struct ChunkOf<2> { using type = unsigned short; };

// VEC consecutive elements of T, moved as one chunk of VEC * sizeof(T)
// bytes (16, or one element on the scalar path).
template <typename T, int VEC> struct Pack {
  using Chunk = typename ChunkOf<VEC * sizeof(T)>::type;
  Chunk c;
  __device__ __forceinline__ void load(const T* p) {
    c = *reinterpret_cast<const Chunk*>(p);
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<Chunk*>(p) = c;
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(&c)[i]);
  }
  __device__ __forceinline__ void set(int i, float x) {
    reinterpret_cast<T*>(&c)[i] = from_f32<T>(x);
  }
};

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

__device__ __forceinline__ bool live_row(const float* valid, int row) {
  return valid == nullptr || valid[row] > 0.0f;
}

// One warp a row, ITEMS 16-byte vectors of s and of t a lane in
// registers; blockDim = (32, kRowsPerWarpBlock). V % VEC == 0.
template <typename T, int ITEMS>
__global__ void __launch_bounds__(32 * kRowsPerWarpBlock)
kd_loss_warp_kernel(const T* __restrict__ s, const T* __restrict__ t,
                    const int* __restrict__ labels,
                    const float* __restrict__ valid, float* __restrict__ out,
                    float* __restrict__ lse, int R, int V, float alpha,
                    float inv_t) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= R) return;                 // uniform over the row's warp
  const int lane = threadIdx.x;
  const int nvec = V / VEC;
  const T* srow = s + static_cast<size_t>(row) * V;
  const T* trow = t + static_cast<size_t>(row) * V;

  Pack<T, VEC> sv[ITEMS], tv[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int v = i * 32 + lane;
    if (v < nvec) {
      sv[i].load(srow + v * VEC);
      tv[i].load(trow + v * VEC);
    }
  }
  const int y = labels[row];
  const bool live = live_row(valid, row);

  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) m = fmaxf(m, sv[i].get(j));
    }
  }
  m = warp_max(m);
  float l = 0.f, gold = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int v = i * 32 + lane;
    if (v < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x = sv[i].get(j);
        l += expf(x - m);
        if (v * VEC + j == y) gold = x;
        const float d = (x - tv[i].get(j)) * inv_t;
        sq = fmaf(d, d, sq);
      }
    }
  }
  l = warp_sum(l);
  gold = warp_sum(gold);
  sq = warp_sum(sq);
  if (lane == 0) {
    const float lz = logf(l) + m;
    out[row] = live ? alpha * (lz - gold) + (1.0f - alpha) * sq : 0.0f;
    if (lse != nullptr) lse[row] = live ? lz : 0.0f;
  }
}

// The strided path: THREADS threads a row, each keeping (max, sumexp,
// gold, sq) partials over columns j = lane, lane + THREADS, ..., merged by
// warp shuffles (and shared memory when a row has more than one warp).
struct Acc {
  float m;     // running max
  float l;     // running sum of exp(s - m)
  float gold;  // s[y] if this thread saw column y, else 0
  float sq;    // running sum of ((s - t) * inv_t)^2
};

// -1e30, not -inf, as in the reference: merging two empty partials must
// not compute (-inf) - (-inf).
__device__ __forceinline__ Acc acc_empty() { return Acc{-1e30f, 0.f, 0.f, 0.f}; }

__device__ __forceinline__ Acc acc_merge(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  Acc r;
  r.m = m;
  r.l = a.l * expf(a.m - m) + b.l * expf(b.m - m);
  r.gold = a.gold + b.gold;
  r.sq = a.sq + b.sq;
  return r;
}

__device__ __forceinline__ Acc warp_reduce(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc b;
    b.m = __shfl_xor_sync(0xffffffffu, a.m, off);
    b.l = __shfl_xor_sync(0xffffffffu, a.l, off);
    b.gold = __shfl_xor_sync(0xffffffffu, a.gold, off);
    b.sq = __shfl_xor_sync(0xffffffffu, a.sq, off);
    a = acc_merge(a, b);
  }
  return a;
}

// blockDim = (THREADS, rows per block).
template <typename T, int THREADS>
__global__ void kd_loss_kernel(const T* __restrict__ s,
                               const T* __restrict__ t,
                               const int* __restrict__ labels,
                               const float* __restrict__ valid,
                               float* __restrict__ out,
                               float* __restrict__ lse, int R, int V,
                               float alpha, float inv_t) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  // Both exits are uniform over the row's threads (a whole warp, or the
  // whole block when THREADS > 32), so no thread misses a shuffle or
  // the barrier below.
  if (row >= R) return;
  if (!live_row(valid, row)) {
    if (threadIdx.x == 0) {
      out[row] = 0.0f;
      if (lse != nullptr) lse[row] = 0.0f;
    }
    return;
  }
  const T* srow = s + static_cast<size_t>(row) * V;
  const T* trow = t + static_cast<size_t>(row) * V;
  const int y = labels[row];

  Acc a = acc_empty();
  for (int j = threadIdx.x; j < V; j += THREADS) {
    const float sv = to_f32(srow[j]);
    const float tv = to_f32(trow[j]);
    if (sv > a.m) {            // online logsumexp, one exp per element
      a.l = a.l * expf(a.m - sv) + 1.0f;
      a.m = sv;
    } else {
      a.l += expf(sv - a.m);
    }
    if (j == y) a.gold = sv;
    const float d = (sv - tv) * inv_t;
    a.sq = fmaf(d, d, a.sq);
  }
  a = warp_reduce(a);
  if constexpr (THREADS > 32) {
    constexpr int kWarps = THREADS / 32;
    __shared__ Acc part[kWarps];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) part[warp] = a;
    __syncthreads();
    if (warp != 0) return;
    a = warp_reduce(lane < kWarps ? part[lane] : acc_empty());
  }
  if (threadIdx.x == 0) {
    const float lz = logf(a.l) + a.m;
    out[row] = alpha * (lz - a.gold) + (1.0f - alpha) * a.sq;
    if (lse != nullptr) lse[row] = lz;
  }
}

// Backward: THREADS threads a row, VEC elements a load (16 bytes, or 1);
// blockDim = (THREADS, rows per block). Each trip first loads UNROLL
// vectors of s and of t a thread, then computes and stores them, so a
// row's loads are in flight together (at V <= 1024 one trip). dt may be
// null.
template <typename T, int THREADS, int VEC, int UNROLL>
__global__ void kd_loss_bwd_kernel(const T* __restrict__ s,
                                   const T* __restrict__ t,
                                   const int* __restrict__ labels,
                                   const float* __restrict__ valid,
                                   const float* __restrict__ g,
                                   long long g_stride,
                                   const float* __restrict__ lse,
                                   T* __restrict__ ds, T* __restrict__ dt,
                                   int R, int V, float alpha, float dsq_scale) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= R) return;
  const size_t base = static_cast<size_t>(row) * V;
  const int nvec = V / VEC;
  const int y = labels[row];
  const bool live = live_row(valid, row);
  const float gr = g[row * g_stride];
  const float lz = lse[row];
  const float beta = 1.0f - alpha;
  for (int v0 = threadIdx.x; v0 < nvec; v0 += THREADS * UNROLL) {
    Pack<T, VEC> sv[UNROLL], tv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v < nvec) {
        sv[u].load(s + base + v * VEC);
        tv[u].load(t + base + v * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int v = v0 + u * THREADS;
      if (v >= nvec) continue;
      Pack<T, VEC> dsv, dtv;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x = sv[u].get(j);
        // the reference's order: dsq = (2 / T^2) (s - t), then
        // g * (alpha * (p - onehot) + (1 - alpha) * dsq)
        const float dsq = dsq_scale * (x - tv[u].get(j));
        const float p = expf(x - lz) - (v * VEC + j == y ? 1.0f : 0.0f);
        dsv.set(j, live ? gr * (alpha * p + beta * dsq) : 0.0f);
        dtv.set(j, live ? gr * (-beta) * dsq : 0.0f);
      }
      dsv.store(ds + base + v * VEC);
      if (dt != nullptr) dtv.store(dt + base + v * VEC);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
void launch_fwd(const void* s, const void* t, const int* labels,
                const float* valid, float* out, float* lse, int R, int V,
                float alpha, float inv_t, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  const dim3 warp_block(32, kRowsPerWarpBlock);
  const dim3 warp_grid((R + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock);
  if (V <= 1024 && V % VEC == 0 && aligned16(s) && aligned16(t)) {
    const int per_lane = (V / VEC + 31) / 32;      // vectors a lane
#define LAUNCH(ITEMS)                                                      \
  kd_loss_warp_kernel<T, ITEMS><<<warp_grid, warp_block, 0, stream>>>(    \
      sp, tp, labels, valid, out, lse, R, V, alpha, inv_t)
    if (per_lane <= 1) {
      LAUNCH(1);
    } else if (per_lane <= 2) {
      LAUNCH(2);
    } else if (per_lane <= 4) {
      LAUNCH(4);
    } else {
      LAUNCH(8);
    }
#undef LAUNCH
  } else if (V <= 1024) {
    kd_loss_kernel<T, 32><<<warp_grid, warp_block, 0, stream>>>(
        sp, tp, labels, valid, out, lse, R, V, alpha, inv_t);
  } else {
    kd_loss_kernel<T, 256><<<R, dim3(256, 1), 0, stream>>>(
        sp, tp, labels, valid, out, lse, R, V, alpha, inv_t);
  }
}

template <typename T>
void launch_bwd(const void* s, const void* t, const int* labels,
                const float* valid, const float* g, long long g_stride,
                const float* lse, void* ds, void* dt, int R, int V,
                float alpha, float dsq_scale, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  T* dsp = static_cast<T*>(ds);
  T* dtp = static_cast<T*>(dt);
  const bool vec = V % VEC == 0 && aligned16(s) && aligned16(t)
      && aligned16(ds) && aligned16(dt);   // a null dt is aligned
#define ARGS sp, tp, labels, valid, g, g_stride, lse, dsp, dtp, R, V, alpha, \
             dsq_scale
  // a warp covers a 16-byte row of V <= 1024 in one trip of 8 vectors
  if (V <= 1024) {
    const dim3 block(32, kRowsPerWarpBlock);
    const dim3 grid((R + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock);
    if (vec)
      kd_loss_bwd_kernel<T, 32, VEC, 8><<<grid, block, 0, stream>>>(ARGS);
    else
      kd_loss_bwd_kernel<T, 32, 1, 8><<<grid, block, 0, stream>>>(ARGS);
  } else {
    if (vec)
      kd_loss_bwd_kernel<T, 256, VEC, 4><<<R, dim3(256, 1), 0, stream>>>(
          ARGS);
    else
      kd_loss_bwd_kernel<T, 256, 1, 4><<<R, dim3(256, 1), 0, stream>>>(
          ARGS);
  }
#undef ARGS
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (s and t share it). valid and lse may
// be null (every row live; no lse written). Returns the cudaError_t of the
// launch.
int kd_loss_fwd(const void* s, const void* t, const void* labels,
                const void* valid, void* out, void* lse, int R, int V,
                float alpha, float inv_t, int dtype, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* val = static_cast<const float*>(valid);
  float* o = static_cast<float*>(out);
  float* lz = static_cast<float*>(lse);
  if (dtype == 0) {
    launch_fwd<float>(s, t, lab, val, o, lz, R, V, alpha, inv_t, st);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(s, t, lab, val, o, lz, R, V, alpha, inv_t,
                              st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (R,) float32 with stride g_stride (elements; 0 for a broadcast
// cotangent); lse: (R,) float32 from kd_loss_fwd. ds and dt (R, V) in the
// logits' dtype; dt may be null (not computed, not written). valid may be
// null. inv_t = 1 / temperature.
int kd_loss_bwd(const void* s, const void* t, const void* labels,
                const void* valid, const void* g, long long g_stride,
                const void* lse, void* ds, void* dt, int R, int V,
                float alpha, float inv_t, int dtype, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* val = static_cast<const float*>(valid);
  const float* gp = static_cast<const float*>(g);
  const float* lz = static_cast<const float*>(lse);
  const float scale = 2.0f * inv_t * inv_t;
  if (dtype == 0) {
    launch_bwd<float>(s, t, lab, val, gp, g_stride, lz, ds, dt, R, V, alpha,
                      scale, st);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(s, t, lab, val, gp, g_stride, lz, ds, dt, R,
                              V, alpha, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kd_loss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
