// One fused Mamba2 SSD token step for Hopper (sm_90a):
//   h'[b,h,p,n] = h[b,h,p,n] * exp(dt[b,h] * A[h]) + dt[b,h] * x[b,h,p] * B[b,n]
//   y[b,h,p]    = sum_n h'[b,h,p,n] * C[b,n]
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_decode_step_pallas
// (body _decode_kernel), which holds the whole decode batch's state in VMEM
// as one program so the state makes one HBM round trip and the rank-1
// update is never materialised.
//
// Bound on the H100: the state is read and written once, 2*B*H*P*N
// elements, plus x, dt, A, B, C and y: at Hymba's decode shape
// (B = 4, H = 50, P = 64, N = 16, f32) ~1.6 MB, 0.5 us at 3.35 TB/s, and
// ~6 flops per state element. At that size the launch and the latency of
// one DRAM round trip cost more than the traffic, so the design keeps the
// round trips to one:
//
// - One block of 256 threads per (b, h), b and h read from blockIdx (no
//   division). At Hymba's shape that is 200 blocks, all resident at once.
// - Vector path (N = 16 or 128, 16-byte aligned operands): each thread
//   owns 16-byte vectors of state rows (4 n-values in f32, 8 in bf16);
//   the N / VEC threads of one row are neighbours, so a block reads its
//   (P, N) tile contiguously. At P = 64, N = 16, f32 the 256 threads
//   cover the tile exactly; at N = 128 a thread holds 8 vectors.
// - Every load (the state vectors, x[b,h,p], the B and C vectors, dt and
//   A) is issued before any arithmetic that needs one of them, so no load
//   waits on another's value; dA = exp(dt * A) is computed once a thread.
// - The readout is each thread's sum over its vector, then a shuffle tree
//   over the lanes of one row (2 xor steps at N = 16, f32).
// - Scalar path (any other N, or operands not aligned for the vectors):
//   a power-of-two group of lanes walks each row's n with a stride.
//
// x, B and C may be views with a batch stride (the conv output they are
// cut from): x is read at x[b * sx + h * P + p], B at B[b * sb + n], C at
// C[b * sc + n]. The state and y are contiguous. state_out may alias state:
// every element is read, then written, by the same thread, and no other
// thread touches it, so the decode cache can be updated in place.
//
// Rounding mirrors the reference op by op, so the kernel and its plain
// version round at the same places in every dtype mix: dA is cast to the
// state's dtype and h * dA rounded there; dt is cast to x's dtype and
// dt * x and (dt * x) * B rounded there; their sum is rounded to
// promote(state, x), the dtype y is written in. Products and sums are
// separate roundings (__fmul_rn / __fadd_rn: no fma contraction). A row
// with dt = 0 gets dA = expf(0) = 1 and an update of +-0, so its state
// comes out bit-identical: ladder pad steps rely on that.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int BYTES> struct ChunkOf;
template <> struct ChunkOf<16> { using type = uint4; };
template <> struct ChunkOf<8> { using type = uint2; };
template <> struct ChunkOf<4> { using type = unsigned int; };

// VEC consecutive elements of T, moved as chunks of at most 16 bytes (the
// address must be aligned to one chunk: kAlign bytes).
template <typename T, int VEC> struct Pack {
  static constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  static constexpr int kAlign = kBytes < 16 ? kBytes : 16;
  using Chunk = typename ChunkOf<kAlign>::type;
  Chunk c[kBytes / kAlign];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kAlign; ++i)
      c[i] = reinterpret_cast<const Chunk*>(p)[i];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kBytes / kAlign; ++i)
      reinterpret_cast<Chunk*>(p)[i] = c[i];
  }
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(c)[i]);
  }
  __device__ __forceinline__ void set(int i, float x) {
    reinterpret_cast<T*>(c)[i] = from_f32<T>(x);
  }
};

// XT: x, B, C; ST: state (in and out); YT: y = promote(ST, XT).
// Grid (H, B); 256 threads. One trip of the p loop covers P <= 64.
template <typename XT, typename ST, typename YT, int N>
__global__ void __launch_bounds__(kThreads)
ssd_decode_vec_kernel(const XT* __restrict__ xh, const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const XT* __restrict__ Bm, const XT* __restrict__ Cm,
                      const ST* state, YT* __restrict__ y, ST* state_out,
                      int H, int P, long long sx, long long sb,
                      long long sc) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(ST));  // n a vector
  constexpr int VPR = N / VEC;            // vectors (lanes) per state row
  constexpr int RPI = kThreads / VPR;     // rows per item
  constexpr int ITEMS = (64 + RPI - 1) / RPI;
  static_assert(N % VEC == 0 && VPR <= 32 && (VPR & (VPR - 1)) == 0,
                "a row's vectors are a power-of-two group of lanes");
  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * H + h;
  const int lane = threadIdx.x % VPR;
  const int r0 = threadIdx.x / VPR;
  const size_t tile = static_cast<size_t>(bh) * P * N;
  const ST* hin = state + tile;
  ST* hout = state_out + tile;
  const XT* xrow = xh + b * sx + static_cast<long long>(h) * P;

  const float dtv = dt[bh];
  const float a = A[h];
  Pack<XT, VEC> bv, cv;
  bv.load(Bm + b * sb + lane * VEC);
  cv.load(Cm + b * sc + lane * VEC);
  for (int p0 = 0; p0 < P; p0 += ITEMS * RPI) {
    Pack<ST, VEC> hv[ITEMS];
    float xv[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = p0 + i * RPI + r0;
      if (p < P) {
        hv[i].load(hin + static_cast<size_t>(p) * N + lane * VEC);
        xv[i] = to_f32(xrow[p]);
      }
    }
    const float dA = round_to<ST>(expf(__fmul_rn(dtv, a)));
    const float dtx = round_to<XT>(dtv);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = p0 + i * RPI + r0;
      float acc = 0.f;
      if (p < P) {
        const float dx = round_to<XT>(__fmul_rn(dtx, xv[i]));
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float decayed = round_to<ST>(__fmul_rn(hv[i].get(j), dA));
          const float upd = round_to<XT>(__fmul_rn(dx, bv.get(j)));
          const float hn = round_to<YT>(__fadd_rn(decayed, upd));
          hv[i].set(j, hn);
          acc = fmaf(hn, cv.get(j), acc);
        }
        hv[i].store(hout + static_cast<size_t>(p) * N + lane * VEC);
      }
      // every lane takes part: the trip count and i are uniform
#pragma unroll
      for (int off = VPR / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off, VPR);
      if (p < P && lane == 0)
        y[static_cast<size_t>(bh) * P + p] = from_f32<YT>(acc);
    }
  }
}

// Any N, any alignment: LPR lanes (a power of two <= 32) per row, lane j
// walking n = j, j + LPR, ...
template <typename XT, typename ST, typename YT, int LPR>
__global__ void __launch_bounds__(kThreads)
ssd_decode_scalar_kernel(const XT* __restrict__ xh,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const XT* __restrict__ Bm,
                         const XT* __restrict__ Cm, const ST* state,
                         YT* __restrict__ y, ST* state_out, int H, int P,
                         int N, long long sx, long long sb, long long sc) {
  constexpr int RPP = kThreads / LPR;
  const int h = blockIdx.x, b = blockIdx.y;
  const int bh = b * H + h;
  const int lane = threadIdx.x % LPR;
  const size_t tile = static_cast<size_t>(bh) * P * N;
  const XT* xrow = xh + b * sx + static_cast<long long>(h) * P;
  const XT* bb = Bm + b * sb;
  const XT* cc = Cm + b * sc;
  const float dtv = dt[bh];
  const float dA = round_to<ST>(expf(__fmul_rn(dtv, A[h])));
  const float dtx = round_to<XT>(dtv);
  for (int p0 = 0; p0 < P; p0 += RPP) {   // uniform over the block
    const int p = p0 + static_cast<int>(threadIdx.x) / LPR;
    float acc = 0.f;
    if (p < P) {
      const float dx = round_to<XT>(__fmul_rn(dtx, to_f32(xrow[p])));
      const ST* hin = state + tile + static_cast<size_t>(p) * N;
      ST* hout = state_out + tile + static_cast<size_t>(p) * N;
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
    if (p < P && lane == 0)
      y[static_cast<size_t>(bh) * P + p] = from_f32<YT>(acc);
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

template <typename XT, typename ST, typename YT>
int launch_t(const void* xh, const float* dt, const float* A, const void* Bm,
             const void* Cm, const void* state, void* y, void* state_out,
             int B, int H, int P, int N, long long sx, long long sb,
             long long sc, cudaStream_t st) {
  const dim3 grid(H, B);
  const XT* x = static_cast<const XT*>(xh);
  const XT* bp = static_cast<const XT*>(Bm);
  const XT* cp = static_cast<const XT*>(Cm);
  const ST* s = static_cast<const ST*>(state);
  ST* so = static_cast<ST*>(state_out);
  YT* yp = static_cast<YT*>(y);
  // the vector path's B / C chunk: VEC elements of XT, at most 16 bytes
  constexpr long long kVec = 16 / sizeof(ST);
  constexpr long long kXBytes = kVec * sizeof(XT);
  constexpr long long kXAlign = kXBytes < 16 ? kXBytes : 16;
  const bool vec = (N == 16 || N == 128) && aligned(state, 16)
      && aligned(state_out, 16) && aligned(Bm, kXAlign)
      && aligned(Cm, kXAlign) && (sb * sizeof(XT)) % kXAlign == 0
      && (sc * sizeof(XT)) % kXAlign == 0;
  if (vec && N == 16) {
    ssd_decode_vec_kernel<XT, ST, YT, 16><<<grid, kThreads, 0, st>>>(
        x, dt, A, bp, cp, s, yp, so, H, P, sx, sb, sc);
  } else if (vec) {
    ssd_decode_vec_kernel<XT, ST, YT, 128><<<grid, kThreads, 0, st>>>(
        x, dt, A, bp, cp, s, yp, so, H, P, sx, sb, sc);
  } else {
#define LAUNCH(LPR)                                                        \
  ssd_decode_scalar_kernel<XT, ST, YT, LPR><<<grid, kThreads, 0, st>>>(   \
      x, dt, A, bp, cp, s, yp, so, H, P, N, sx, sb, sc)
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
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x_dtype (x, B, C) and state_dtype: 0 = float32, 1 = bfloat16. y is
// float32 unless both are bfloat16. dt (B, H) and A (H,) are float32 and
// contiguous, as are the state, state_out and y. sx, sb, sc: the batch
// strides of x (B, H, P; head stride P, unit p stride), B and C (B, N;
// unit n stride), in elements. state_out may alias state. Returns the
// launch's cudaError_t.
int ssd_decode_step_fwd(const void* xh, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* state,
                        void* y, void* state_out, int B, int H, int P, int N,
                        long long sx, long long sb, long long sc,
                        int x_dtype, int state_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  if (B <= 0 || H <= 0 || P <= 0) return 0;
  if (N < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
#define ARGS xh, d, a, Bm, Cm, state, y, state_out, B, H, P, N, sx, sb, sc, st
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
