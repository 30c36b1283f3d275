// Mamba2 SSD chunk scan for Hopper (sm_90a): the whole SSD layer core of one
// sequence, chunk by chunk, the (P, N) state carried on chip. Per chunk of
// Q rows, with dA = dt * A and cum = cumsum(dA) inside the chunk:
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) (x_j dt_j)
//           + exp(cum_i) (C_i . h)                         (h entering)
//   h    <- h exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) B_j
// and the final h is returned beside y.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _kernel), whose sequential (BH, chunk) grid carries h in VMEM scratch.
// Here one block of 256 threads (a 16 x 16 grid) per (b, h) walks the
// chunks in order and keeps h in shared memory; nothing carries between
// blocks. B and C are read as (B, S, N), indexed by b: the reference's
// per-head broadcast copies are a BlockSpec artefact.
//
// The block's chunk is its own, Q = 16 * RI rows (128, or 64 where a
// 128-row chunk's buffers would not fit shared memory): the scan is the
// same function whatever the chunk, which only splits its sums
// differently. Rows past S are treated as dt = 0 rows, which leave h
// exactly as it was, and are not written.
//
// Per chunk, all in shared memory as f32: dt (then cum, in place), x dt
// (Q x P), B and C (Q x N), the decayed score tile G = (C B^T) (.) L, zero
// above the diagonal, stored transposed (G^T, Q x Q), and h (P x N).
//   1. load dt, B and C, then x (4-element vector loads, every load of a
//      batch issued before its stores); x dt; one warp turns dt into cum
//      (a warp scan);
//   2. G: each thread a register tile of rows ty * RI + a, keys tx + 16 c;
//   3. y: each thread rows ty * RI + a (read as 4-wide vectors of G^T),
//      columns tx + 16 b, over keys j up to its last row, plus
//      exp(cum_i) (C_i . h);
//   4. h: each thread state elements (ty + 16 a, tx + 16 c).
//
// Bound on the H100: the function reads x, dt, A, B, C once and writes y
// and the final state once; at Hymba's scoring shape (B = 2, S = 2048,
// H = 50, P = 64, N = 16, f32) that is ~106 MB (32 us at 3.35 TB/s)
// against ~3.0 GFLOP of f32 work on the causal triangle (45 us at
// 67 TFLOP/s). Only B * H = 100 blocks run, one per (b, h), on the 132 SMs,
// and each walks its 16 chunks in sequence.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kPB = kMaxP / 16;   // columns of y a thread owns
constexpr int kBatch = 8;         // vector loads in flight a thread

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [0, Q) x cols4 4-element groups of M row-major matrices into
// dst[m] (row stride ld, f32), times scale[r] when given. Row r of matrix m
// starts at src[m] + r * stride when r < nq and is zero past it. Every
// load of a batch is issued before its stores: kBatch / M rows' vectors of
// each matrix in flight a thread.
template <int M, typename T>
__device__ __forceinline__ void load_rows(float* const (&dst)[M],
                                          const T* const (&src)[M],
                                          size_t stride, int ld, int Q,
                                          int cols4, int nq,
                                          const float* scale) {
  constexpr int kPer = kBatch / M;
  const int total = Q * cols4;
  for (int base = threadIdx.x; base < total; base += kThreads * kPer) {
    float4 v[M][kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / cols4, c = idx % cols4;
#pragma unroll
      for (int m = 0; m < M; ++m)
        v[m][u] = (idx < total && r < nq)
                      ? load4(src[m] + r * stride + 4 * c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = base + u * kThreads;
      if (idx >= total) break;
      const int r = idx / cols4, c = idx % cols4;
      const float s = scale ? scale[r] : 1.f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float* d = dst[m] + r * ld + 4 * c;
        d[0] = v[m][u].x * s;
        d[1] = v[m][u].y * s;
        d[2] = v[m][u].z * s;
        d[3] = v[m][u].w * s;
      }
    }
  }
}

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(Q) * P + 2 * static_cast<size_t>(Q) * (N + 1) +
         static_cast<size_t>(Q) * (Q + 4) +
         static_cast<size_t>(P) * (N + 1) + Q;
}

// RI: rows of the chunk a thread owns (Q = 16 * RI); NB: state columns a
// thread owns in step 4, ceil(N / 16) rounded up to a power of two, so a
// narrow state (Hymba's N = 16) runs no idle columns
template <typename T, int RI, int NB>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                T* __restrict__ h_out, int S, int H, int P, int N) {
  constexpr int Q = 16 * RI;
  constexpr int ldg = Q + 4;   // G^T rows stay 16-byte aligned
  extern __shared__ float4 smem4[];
  const int ldn = N + 1;
  float* xdt_s = reinterpret_cast<float*>(smem4);   // (Q, P)
  float* gT_s = xdt_s + Q * P;                       // (Q, Q + 4): [j][i]
  float* b_s = gT_s + Q * ldg;                       // (Q, N + 1)
  float* c_s = b_s + Q * ldn;                        // (Q, N + 1)
  float* h_s = c_s + Q * ldn;                        // (P, N + 1)
  float* cum_s = h_s + P * ldn;                      // (Q,)

  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = ty * RI;   // this thread's first row in steps 2 and 3
  const float a_h = A[hd];

  for (int i = tid; i < P * ldn; i += kThreads) h_s[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += Q) {
    const int nq = min(Q, S - s0);   // live rows of this chunk
    const size_t row0 = static_cast<size_t>(b) * S + s0;
    __syncthreads();   // the previous chunk is done with every buffer
    // 1. dt (into cum_s), B and C, then x dt; rows >= nq are zeros (dt = 0)
    {
      const float dtv = tid < nq ? dt[(row0 + tid) * H + hd] : 0.f;
      float* const bc_dst[2] = {b_s, c_s};
      const T* const bc_src[2] = {Bm + row0 * N, Cm + row0 * N};
      load_rows<2, T>(bc_dst, bc_src, N, ldn, Q, N / 4, nq, nullptr);
      if (tid < Q) cum_s[tid] = dtv;
    }
    __syncthreads();
    {
      float* const x_dst[1] = {xdt_s};
      const T* const x_src[1] = {x + (row0 * H + hd) * P};
      load_rows<1, T>(x_dst, x_src, static_cast<size_t>(H) * P, P, Q, P / 4,
                      nq, cum_s);
    }
    __syncthreads();
    if (tid < 32) {   // cum = cumsum(dt * A): each lane a run, then a scan
      constexpr int per = (Q + 31) / 32;
      const int j0 = tid * per;
      float run = 0.f;
#pragma unroll
      for (int j = j0; j < j0 + per; ++j) run += cum_s[j] * a_h;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float acc = incl - run;
#pragma unroll
      for (int j = j0; j < j0 + per; ++j) {
        acc += cum_s[j] * a_h;
        cum_s[j] = acc;
      }
    }
    __syncthreads();

    // 2. G[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0,
    //    stored as G^T[j][i]
    {
      float g[RI][RI];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int c = 0; c < RI; ++c) g[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cr[RI], br[RI];
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          cr[a] = c_s[(i0 + a) * ldn + n];
          br[a] = b_s[(tx + 16 * a) * ldn + n];
        }
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int c = 0; c < RI; ++c) g[a][c] = fmaf(cr[a], br[c], g[a][c]);
      }
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int i = i0 + a;
#pragma unroll
        for (int c = 0; c < RI; ++c) {
          const int j = tx + 16 * c;
          gT_s[j * ldg + i] =
              j <= i ? g[a][c] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 3. y = G (x dt) + exp(cum) (C h^T), rows i0 + a, cols tx + 16 b
    {
      float acc[RI][kPB];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int c = 0; c < kPB; ++c) acc[a][c] = 0.f;
#pragma unroll 2
      for (int j = 0; j < i0 + RI; ++j) {   // G is zero past the last row
        float g[RI], xr[kPB];
#pragma unroll
        for (int a = 0; a < RI; a += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(gT_s + j * ldg + i0 + a);
          g[a] = t.x;
          g[a + 1] = t.y;
          g[a + 2] = t.z;
          g[a + 3] = t.w;
        }
#pragma unroll
        for (int c = 0; c < kPB; ++c) {
          const int p = tx + 16 * c;
          xr[c] = p < P ? xdt_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int c = 0; c < kPB; ++c) acc[a][c] = fmaf(g[a], xr[c], acc[a][c]);
      }
      float inter[RI][kPB];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int c = 0; c < kPB; ++c) inter[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float hr[kPB];
#pragma unroll
        for (int c = 0; c < kPB; ++c) {
          const int p = tx + 16 * c;
          hr[c] = p < P ? h_s[p * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          const float cv = c_s[(i0 + a) * ldn + n];
#pragma unroll
          for (int c = 0; c < kPB; ++c)
            inter[a][c] = fmaf(cv, hr[c], inter[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int i = i0 + a;
        if (i >= nq) continue;
        const float ec = expf(cum_s[i]);
        T* yr = y + ((row0 + i) * H + hd) * P;
#pragma unroll
        for (int c = 0; c < kPB; ++c) {
          const int p = tx + 16 * c;
          if (p < P) store1(yr + p, acc[a][c] + ec * inter[a][c]);
        }
      }
    }
    __syncthreads();   // every y row has read the entering h

    // 4. h <- h exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) B_j;
    //    the decays go to the first row of G^T, free now
    const float cum_last = cum_s[Q - 1];
    if (tid < Q) gT_s[tid] = expf(cum_last - cum_s[tid]);
    __syncthreads();
    {
      float acc[kPB][NB];
#pragma unroll
      for (int a = 0; a < kPB; ++a)
#pragma unroll
        for (int c = 0; c < NB; ++c) acc[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float dec = gT_s[j];
        float w[kPB], br[NB];
#pragma unroll
        for (int a = 0; a < kPB; ++a) {
          const int p = ty + 16 * a;
          w[a] = p < P ? xdt_s[j * P + p] * dec : 0.f;
        }
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int n = tx + 16 * c;
          br[c] = n < N ? b_s[j * ldn + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kPB; ++a)
#pragma unroll
          for (int c = 0; c < NB; ++c) acc[a][c] = fmaf(w[a], br[c], acc[a][c]);
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int a = 0; a < kPB; ++a) {
        const int p = ty + 16 * a;
        if (p >= P) continue;
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          const int n = tx + 16 * c;
          if (n < N) h_s[p * ldn + n] = h_s[p * ldn + n] * decay + acc[a][c];
        }
      }
    }
  }
  __syncthreads();
  T* ho = h_out + (static_cast<size_t>(b) * H + hd) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    store1(ho + i, h_s[(i / N) * ldn + i % N]);
}

template <typename T, int RI, int NB>
int launch_t(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
             int N, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T, RI, NB>;
  const size_t smem = sizeof(float) * smem_floats(16 * RI, P, N);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<T*>(h_out),
      S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RI>
int launch_n(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
             int N, cudaStream_t st) {
#define ARGS x, dt, A, Bm, Cm, y, h_out, B, S, H, P, N, st
  if (N <= 16) return launch_t<T, RI, 1>(ARGS);
  if (N <= 32) return launch_t<T, RI, 2>(ARGS);
  if (N <= 64) return launch_t<T, RI, 4>(ARGS);
  return launch_t<T, RI, 8>(ARGS);
#undef ARGS
}

template <typename T>
int launch_q(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
             int N, int Q, cudaStream_t st) {
  if (Q == 128)
    return launch_n<T, 8>(x, dt, A, Bm, Cm, y, h_out, B, S, H, P, N, st);
  if (Q == 64)
    return launch_n<T, 4>(x, dt, A, Bm, Cm, y, h_out, B, S, H, P, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, y and the final state alike);
// dt (B, S, H) and A (H,) are float32. Q, the block's chunk, is 128 or 64;
// P <= 64 and N <= 128, both multiples of 4; x, B and C 16-byte aligned.
// Returns the launch's cudaError_t.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* h_out, int B, int S, int H,
                 int P, int N, int Q, int dtype, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (P < 4 || P > kMaxP || P % 4 || N < 4 || N > kMaxN || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  if (dtype == 0)
    return launch_q<float>(x, d, a, Bm, Cm, y, h_out, B, S, H, P, N, Q, st);
  if (dtype == 1)
    return launch_q<__nv_bfloat16>(x, d, a, Bm, Cm, y, h_out, B, S, H, P, N,
                                   Q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
