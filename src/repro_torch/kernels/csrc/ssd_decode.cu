// One fused Mamba2 SSD token step for Hopper (sm_90a):
//   h'[b,h,p,n] = h[b,h,p,n] * exp(dt[b,h] * A[h]) + dt[b,h] * x[b,h,p] * B[b,n]
//   y[b,h,p]    = sum_n h'[b,h,p,n] * C[b,n]
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_decode_step_pallas
// (body _decode_kernel), which holds the whole decode batch's state in VMEM
// as one program so the state makes one HBM round trip and the rank-1
// update is never materialised.
//
// Design. The state is read once and written once. A group of LPR lanes
// (a power of two <= 32, the smallest >= min(N, 32)) owns one (b, h, p)
// row: lane j walks n = j, j + LPR, ... so a warp reads whole rows of the
// (B, H, P, N) state contiguously, computes h', writes it in the state's
// dtype, and accumulates h' * C[n] in f32; the LPR partial sums meet by
// shuffles. B and C (B x N) are re-read by every row of a batch row from
// L1/L2; the wrapper counts them once in the bound.
//
// Rounding mirrors the reference op by op, so the kernel and its plain
// version round at the same places in every dtype mix: dA is cast to the state's
// dtype and h * dA rounded there; dt is cast to x's dtype and dt * x and
// (dt * x) * B rounded there; their sum is rounded to promote(state, x),
// the dtype y is written in. Products and sums are separate roundings
// (__fmul_rn / __fadd_rn: no fma contraction). A row with dt = 0 gets
// dA = expf(0) = 1 and an update of +-0, so its state comes out
// bit-identical: ladder pad steps rely on that.
//
// Bound on the H100: the state is read and written once, 2*B*H*P*N
// elements, plus x, dt, A, B, C and y: at Hymba's decode shape
// (B = 4, H = 50, P = 64, N = 16, f32) ~1.6 MB, 0.5 us at 3.35 TB/s, and
// ~6 flops per state element: bytes-bound, and at that size the launch
// costs more than the traffic.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
// x rounded to T's precision, as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// XT: x, B, C; ST: state (in and out); YT: y = promote(ST, XT).
template <typename XT, typename ST, typename YT, int LPR>
__global__ void __launch_bounds__(kThreads)
ssd_decode_kernel(const XT* __restrict__ xh, const float* __restrict__ dt,
                  const float* __restrict__ A, const XT* __restrict__ Bm,
                  const XT* __restrict__ Cm, const ST* __restrict__ state,
                  YT* __restrict__ y, ST* __restrict__ state_out, int rows,
                  int H, int P, int N) {
  const int row = blockIdx.x * (kThreads / LPR) + threadIdx.x / LPR;
  const int lane = threadIdx.x % LPR;
  // no early return: every lane of the warp takes part in the shuffles
  const bool live = row < rows;
  float acc = 0.f;
  if (live) {
    const int bh = row / P;             // row = (b * H + h) * P + p
    const int b = bh / H, h = bh % H;
    const float dtv = dt[bh];
    const float dA = round_to<ST>(expf(dtv * A[h]));
    const float dx = round_to<XT>(__fmul_rn(round_to<XT>(dtv),
                                            to_f32(xh[row])));
    const ST* hin = state + static_cast<size_t>(row) * N;
    ST* hout = state_out + static_cast<size_t>(row) * N;
    const XT* bb = Bm + static_cast<size_t>(b) * N;
    const XT* cc = Cm + static_cast<size_t>(b) * N;
    for (int n = lane; n < N; n += LPR) {
      const float decayed = round_to<ST>(__fmul_rn(to_f32(hin[n]), dA));
      const float upd = round_to<XT>(__fmul_rn(dx, to_f32(bb[n])));
      const float hn = round_to<YT>(__fadd_rn(decayed, upd));
      hout[n] = from_f32<ST>(hn);
      acc = fmaf(hn, to_f32(cc[n]), acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, LPR);
  if (live && lane == 0) y[row] = from_f32<YT>(acc);
}

template <typename XT, typename ST, typename YT>
int launch_t(const void* xh, const float* dt, const float* A, const void* Bm,
             const void* Cm, const void* state, void* y, void* state_out,
             int rows, int H, int P, int N, cudaStream_t st) {
#define LAUNCH(LPR)                                                        \
  ssd_decode_kernel<XT, ST, YT, LPR>                                      \
      <<<(rows + kThreads / LPR - 1) / (kThreads / LPR), kThreads, 0,     \
         st>>>(static_cast<const XT*>(xh), dt, A,                         \
               static_cast<const XT*>(Bm), static_cast<const XT*>(Cm),    \
               static_cast<const ST*>(state), static_cast<YT*>(y),        \
               static_cast<ST*>(state_out), rows, H, P, N)
  if (N <= 4) {
    LAUNCH(4);
  } else if (N <= 8) {
    LAUNCH(8);
  } else if (N <= 16) {
    LAUNCH(16);
  } else {
    LAUNCH(32);
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_dtype (x, B, C) and state_dtype: 0 = float32, 1 = bfloat16. y is
// float32 unless both are bfloat16. dt (B, H) and A (H,) are float32.
// state_out may alias state (each element is read, then written, by the
// same thread). Returns the launch's cudaError_t.
int ssd_decode_step_fwd(const void* xh, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* state,
                        void* y, void* state_out, int B, int H, int P, int N,
                        int x_dtype, int state_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  const int rows = B * H * P;
  if (rows <= 0) return 0;
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
#define ARGS xh, d, a, Bm, Cm, state, y, state_out, rows, H, P, N, st
  if (x_dtype == 0 && state_dtype == 0)
    return launch_t<float, float, float>(ARGS);
  if (x_dtype == 0 && state_dtype == 1)
    return launch_t<float, bf16, float>(ARGS);
  if (x_dtype == 1 && state_dtype == 0)
    return launch_t<bf16, float, float>(ARGS);
  if (x_dtype == 1 && state_dtype == 1)
    return launch_t<bf16, bf16, bf16>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
