// Fused KD loss for Hopper (sm_90a):
//   out[r] = alpha * (logsumexp(s[r]) - s[r, y[r]])
//          + (1 - alpha) * sum_v ((s[r, v] - t[r, v]) * inv_t)^2
// and exactly 0.0 where valid[r] <= 0 (a select: garbage logits in masked
// rows are never read, so NaN/Inf cannot reach the output).
//
// Replaces the TPU kernel repro/kernels/kd_loss.py::kd_loss_pallas (its
// body _kernel), which streams vocab tiles through VMEM carrying an online
// (max, sumexp), the gathered gold logit and the running squared error in
// scratch across a sequential grid axis.
//
// On Hopper the grid has no order, so the vocab sweep is a strided loop
// inside one row's threads: each thread keeps its own (max, sumexp, gold,
// sq) partials over columns j = lane, lane + THREADS, ..., and the partials
// are merged by warp shuffles (and shared memory when a row has more than
// one warp). V <= 1024: one warp per row, four rows per block. Larger V: one
// 256-thread block per row. s and t are each read exactly once in their
// own dtype (f32 or bf16); all arithmetic is f32.
//
// Bound on the H100: the function must read 2*R*V elements of s and t
// (plus R labels and masks) and write R floats, about R*V*8 bytes in f32.
// At the main path's R = 4, V = 400 that is ~13 KB, a few nanoseconds at
// 3.35 TB/s: the launch (a few microseconds) bounds it, not memory or
// arithmetic. A simple, right kernel is the goal here.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream and the return value is
// cudaGetLastError() right after it (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Acc {
  float m;     // running max
  float l;     // running sum of exp(s - m)
  float gold;  // s[y] if this thread saw column y, else 0
  float sq;    // running sum of ((s - t) * inv_t)^2
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// THREADS threads serve one row; blockDim = (THREADS, rows per block).
template <typename T, int THREADS>
__global__ void kd_loss_kernel(const T* __restrict__ s,
                               const T* __restrict__ t,
                               const int* __restrict__ labels,
                               const float* __restrict__ valid,
                               float* __restrict__ out, int R, int V,
                               float alpha, float inv_t) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  // Both exits are uniform over the row's threads (a whole warp, or the
  // whole block when THREADS > 32), so no thread misses a shuffle or
  // the barrier below.
  if (row >= R) return;
  if (!(valid[row] > 0.0f)) {
    if (threadIdx.x == 0) out[row] = 0.0f;
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
    const float ce = logf(a.l) + a.m - a.gold;
    out[row] = alpha * ce + (1.0f - alpha) * a.sq;
  }
}

constexpr int kRowsPerWarpBlock = 4;

template <typename T>
void launch(const void* s, const void* t, const int* labels,
            const float* valid, float* out, int R, int V, float alpha,
            float inv_t, cudaStream_t stream) {
  const T* sp = static_cast<const T*>(s);
  const T* tp = static_cast<const T*>(t);
  if (V <= 1024) {
    dim3 block(32, kRowsPerWarpBlock);
    dim3 grid((R + kRowsPerWarpBlock - 1) / kRowsPerWarpBlock);
    kd_loss_kernel<T, 32><<<grid, block, 0, stream>>>(
        sp, tp, labels, valid, out, R, V, alpha, inv_t);
  } else {
    dim3 block(256, 1);
    dim3 grid(R);
    kd_loss_kernel<T, 256><<<grid, block, 0, stream>>>(
        sp, tp, labels, valid, out, R, V, alpha, inv_t);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (s and t share it). Returns the
// cudaError_t of the launch.
int kd_loss_fwd(const void* s, const void* t, const void* labels,
                const void* valid, void* out, int R, int V, float alpha,
                float inv_t, int dtype, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* val = static_cast<const float*>(valid);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    launch<float>(s, t, lab, val, o, R, V, alpha, inv_t, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(s, t, lab, val, o, R, V, alpha, inv_t, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kd_loss_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
