// Mamba2 SSD chunk scan for Hopper (sm_90a): the whole SSD layer core of a
// batch, the sequence split into chunks that run on the whole card. Per
// chunk of Q rows, with dA = dt * A and cum = cumsum(dA) inside the chunk:
//   y[i]  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) (C_i . h)                         (h entering)
//   h    <- h exp(cum_last) + sum_j (x_j dt_j exp(cum_last - cum_j)) B_j
// and the final h is returned beside y.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _kernel), whose sequential (BH, chunk) grid carries h in VMEM scratch.
// On the H100 a grid runs in no order, so one call runs three kernels on
// the caller's stream, the carry between chunks made explicit:
//   1. chunk states, one block per (b, h, chunk): cum, the chunk's state
//      contribution sum_j (x_j dt_j exp(cum_last - cum_j)) B_j (P x N) and
//      its decay exp(cum_last), into f32 scratch;
//   2. state passing, one thread per (b, h, p, n): h <- h decay +
//      contribution over the chunks in order (the loads of 16 chunks in
//      flight ahead of the dependent updates), each chunk's entering state
//      written over its contribution, the final state in x's dtype;
//   3. chunk outputs, one block per (b, h, chunk): y from the chunk's own
//      rows and its entering state, written once in x's dtype.
// Passes 1 and 3 are one template (kOut). The blocks of one (b, chunk) run
// side by side over h, so the chunk's B and C rows stay in L2. B and C are
// read as (B, S, N), indexed by b: the reference's per-head broadcast
// copies are a BlockSpec artefact.
//
// The kernels' chunk is their own, Q = 64 rows: the scan is the same
// function whatever the chunk, which only splits its sums differently, and
// 64 rows halve the causal triangle of 128 and double the blocks. Rows past
// S are treated as dt = 0 rows, which leave h exactly as it was (decay
// exp(0) = 1, contribution 0), and are not written.
//
// Passes 1 and 3 run their products on the tensor cores (tf32_mma.cuh),
// 3xTF32 for f32 accuracy. A block of four warps loads its chunk's rows
// (x, dt, B, and for the outputs C and the entering state) into shared
// memory as f32, every copy in flight at once (cp.async for f32 inputs);
// one warp turns dt into cum; then
//   pass 1: warp w owns state rows p in [16 w, 16 w + 16) of the product
//     (x (.) w)^T B over the chunk's rows, w_j = dt_j exp(cum_last - cum_j),
//     x read transposed from shared memory;
//   pass 3: warp w owns the chunk's rows i in [16 w, 16 w + 16): S = C B^T
//     over the keys j <= 16 w + 15 only (the causal triangle), then in the
//     accumulator registers G = S (.) exp(cum_i - cum_j) dt_j below the
//     diagonal and an exact 0 above it; y = G x + (C (.) exp(cum)) h^T,
//     G read straight from those registers (the attention kernel's key
//     order: lanes hold keys 2t, 2t + 1 of each 8-key group), the entering
//     state h as stored (P x N).
// P and N are padded to multiples of 8 in shared memory, with zeros where
// they enter a product's sum. Row strides are chosen so that each fragment
// read of a warp falls on distinct banks.
//
// Bound on the H100: the function reads x, dt, A, B, C once and writes y
// and the final state once; at Hymba's scoring shape (B = 2, S = 2048,
// H = 50, P = 64, N = 16, f32) that is ~106 MB (32 us at 3.35 TB/s)
// against ~3.0 GFLOP of f32 work on the causal triangle at the reference's
// 128-row chunk (45 us at 67 TFLOP/s on the FMA pipes). The split reads x
// twice (passes 1 and 3) and moves the f32 chunk states, B H (S / 64) P N
// (13 MB there), through scratch, mostly in L2. It runs B H S / 64 blocks
// in each of passes 1 and 3 (3200 there) on the 132 SMs, where a block per
// (b, h) walking its chunks in order ran 100.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launches go on the caller's stream; the entry returns the first
// launch's error (cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

using tf32::AFrag;
using tf32::mma_b;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kQ = 16 * kWarps;   // the kernels' chunk: rows of a block
constexpr int kPassThreads = 256;
constexpr int kPassBatch = 16;    // chunks' loads in flight in pass 2

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
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
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [0, rows) x c4 groups of 4 values into dst (row stride ld, f32):
// row r of src starts at src + r * stride; a group is copied when r < nr
// and it is one of the first c4_valid of its row, else zeros. f32 goes by
// cp.async (the caller waits), bf16 through registers.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          size_t stride, int rows, int c4,
                                          int c4_valid, int nr) {
  for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
    const int r = idx / c4, c = idx % c4;
    const bool ok = r < nr && c < c4_valid;
    float* d = dst + r * ld + 4 * c;
    const T* s = src + (ok ? r * stride + 4 * c : 0);
    if constexpr (std::is_same<T, float>::value) {
      tf32::cp_async16(d, s, ok);
    } else {
      *reinterpret_cast<float4*>(d) =
          ok ? load4(s) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Row strides (floats) of the shared-memory tiles: 16-byte multiples, each
// chosen so that the fragment reads of a warp fall on distinct banks
struct Layout {
  int P8, N8;
  int ld_x;   // x (Q, ld_x): pass 1 reads it transposed (A), pass 3 as B
  int ld_b;   // B (Q, ld_b): pass 1 as B (k = row), pass 3 as B (n = row)
  int ld_n;   // pass 3: C (Q, ld_n) and the entering state (P8, ld_n)
  __host__ __device__ Layout(int P, int N, bool out)
      : P8(round_up(P, 8)), N8(round_up(N, 8)), ld_x(0), ld_b(0),
        ld_n(N8 + 4) {
    ld_x = out ? P8 + 4 : round_up(P8, 32) + 8;
    ld_b = out ? ld_n : round_up(N8, 16) + 8;
  }
  // x, B, dt, cum, then pass 1's row weights or pass 3's C and state
  __host__ __device__ size_t floats(bool out) const {
    const size_t base = static_cast<size_t>(kQ) * (ld_x + ld_b) + 2 * kQ;
    return out ? base + static_cast<size_t>(kQ + P8) * ld_n : base + kQ;
  }
};

// Passes 1 (kOut = false) and 3 (kOut = true). NT: 8-column groups of the
// state pass 1 holds a lane, N8 / 8 rounded up to a power of two, so a
// narrow state (Hymba's N = 16) holds no idle accumulators. states:
// (B, H, nc, P, N) f32, written by pass 1 (contributions), read by pass 3
// (entering states); decay: (B, H, nc) f32, written by pass 1.
template <typename T, bool kOut, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay,
                 int S, int H, int P, int N, int nc) {
  constexpr bool kF32 = std::is_same<T, float>::value;   // else exact TF32
  const Layout lay(P, N, kOut);
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);
  float* b_s = x_s + kQ * lay.ld_x;
  float* dt_s = b_s + kQ * lay.ld_b;
  float* cum_s = dt_s + kQ;
  float* w_s = cum_s + kQ;            // pass 1: (Q,) row weights
  float* c_s = cum_s + kQ;            // pass 3: (Q, ld_n)
  float* h_s = c_s + kQ * lay.ld_n;   // pass 3: (P8, ld_n)

  // block = (b, chunk, h), h fastest
  const int hd = blockIdx.x % H;
  const int bc = blockIdx.x / H, c = bc % nc, b = bc / nc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nq = min(kQ, S - c * kQ);   // live rows of this chunk
  const size_t row0 = static_cast<size_t>(b) * S + c * kQ;
  const size_t chunk_id = (static_cast<size_t>(b) * H + hd) * nc + c;
  float* st = states + chunk_id * P * N;

  // every load of the chunk in flight at once; rows >= nq and the padding
  // columns are zeros (dt = 0 rows)
  load_tile<T>(x_s, lay.ld_x, x + (row0 * H + hd) * P,
               static_cast<size_t>(H) * P, kQ, lay.P8 / 4, P / 4, nq);
  load_tile<T>(b_s, lay.ld_b, Bm + row0 * N, N, kQ, lay.N8 / 4, N / 4, nq);
  if (kOut) {
    load_tile<T>(c_s, lay.ld_n, Cm + row0 * N, N, kQ, lay.N8 / 4, N / 4, nq);
    if (c > 0)   // the first chunk enters with h = 0
      load_tile<float>(h_s, lay.ld_n, st, N, lay.P8, lay.N8 / 4, N / 4, P);
  }
  tf32::cp_commit();
  if (tid < kQ) dt_s[tid] = tid < nq ? dt[(row0 + tid) * H + hd] : 0.f;
  tf32::cp_wait<0>();
  __syncthreads();
  if (tid < 32) {   // cum = cumsum(dt * A): each lane two rows, then a scan
    const float a_h = A[hd];
    const float d0 = dt_s[2 * tid] * a_h, d1 = dt_s[2 * tid + 1] * a_h;
    float incl = d0 + d1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += o;
    }
    const float excl = incl - (d0 + d1);
    cum_s[2 * tid] = excl + d0;
    cum_s[2 * tid + 1] = excl + d0 + d1;
  }
  __syncthreads();

  if (!kOut) {
    // pass 1: contribution[p][n] = sum_j x[j][p] w_j B[j][n]; A = x^T
    // scaled by the row weights, B as stored
    const float cum_last = cum_s[kQ - 1];
    if (tid < kQ) w_s[tid] = expf(cum_last - cum_s[tid]) * dt_s[tid];
    if (tid == 0) decay[chunk_id] = expf(cum_last);
    __syncthreads();
    const int p0 = 16 * warp;
    if (p0 >= lay.P8) return;
    const int n_nt = lay.N8 / 8;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kQ; kk += 8) {
      const float w0 = w_s[kk + t], w1 = w_s[kk + t + 4];
      const float* xr = x_s + (kk + t) * lay.ld_x + p0 + g;
      const float av[4] = {xr[0] * w0, xr[8] * w0, xr[4 * lay.ld_x] * w1,
                           xr[4 * lay.ld_x + 8] * w1};
      const AFrag<true> a(av);
      const float* br = b_s + (kk + t) * lay.ld_b + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (nt < n_nt)
          mma_b<kF32, true>(acc[nt], a, br[8 * nt], br[4 * lay.ld_b + 8 * nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + g + 8 * (e >> 1), n = 8 * nt + 2 * t + (e & 1);
        if (nt < n_nt && p < P && n < N) st[p * N + n] = acc[nt][e];
      }
    return;
  }

  // pass 3: the warp's rows i0 + g (r = 0) and i0 + g + 8 (r = 1); the
  // 8-key groups j < n_j reach the diagonal, the rest of G is 0
  const int i0 = 16 * warp;
  const int n_j = 2 * warp + 2;
  float s[kQ / 8][4];   // S = C B^T
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int kk = 0; kk < lay.N8; kk += 8) {
    const float* cr = c_s + (i0 + g) * lay.ld_n + kk + t;
    const float cv[4] = {cr[0], cr[8 * lay.ld_n], cr[4],
                         cr[8 * lay.ld_n + 4]};
    const AFrag<kF32> a(cv);
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j)
      if (j < n_j) {
        const float* br = b_s + (8 * j + g) * lay.ld_b + kk + t;
        mma_b<kF32, kF32>(s[j], a, br[0], br[4]);
      }
  }
  // G = S (.) exp(cum_i - cum_j) dt_j for j <= i, else an exact 0
  const float cum_i[2] = {cum_s[i0 + g], cum_s[i0 + g + 8]};
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), jj = 8 * j + 2 * t + (e & 1);
      s[j][e] = jj <= i
                    ? s[j][e] * expf(cum_i[e >> 1] - cum_s[jj]) * dt_s[jj]
                    : 0.f;
    }

  // y = G x + (C (.) exp(cum)) h^T; columns 8 cc + 2t, + 1 of the lane
  const int n_pt = lay.P8 / 8;
  float acc[kMaxP / 8][4];
#pragma unroll
  for (int cc = 0; cc < kMaxP / 8; ++cc)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[cc][e] = 0.f;
  // G's A fragment of group j is (G[g][2t], G[g+8][2t], G[g][2t+1],
  // G[g+8][2t+1]): the product's k index t reads key 2t of the group and
  // t + 4 key 2t + 1
#pragma unroll
  for (int j = 0; j < kQ / 8; ++j)
    if (j < n_j) {
      const float gv[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      const AFrag<true> a(gv);
      const float* xr = x_s + (8 * j + 2 * t) * lay.ld_x + g;
#pragma unroll
      for (int cc = 0; cc < kMaxP / 8; ++cc)
        if (cc < n_pt)
          mma_b<kF32, true>(acc[cc], a, xr[8 * cc], xr[lay.ld_x + 8 * cc]);
    }
  if (c > 0) {
    const float e0 = expf(cum_i[0]), e1 = expf(cum_i[1]);
    for (int kk = 0; kk < lay.N8; kk += 8) {
      const float* cr = c_s + (i0 + g) * lay.ld_n + kk + t;
      const float cv[4] = {cr[0] * e0, cr[8 * lay.ld_n] * e1, cr[4] * e0,
                           cr[8 * lay.ld_n + 4] * e1};
      const AFrag<true> a(cv);
      const float* hr = h_s + g * lay.ld_n + kk + t;
#pragma unroll
      for (int cc = 0; cc < kMaxP / 8; ++cc)
        if (cc < n_pt)   // the state is f32 whatever x's dtype
          mma_b<true, true>(acc[cc], a, hr[8 * cc * lay.ld_n],
                            hr[8 * cc * lay.ld_n + 4]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i >= nq) continue;
    T* yr = y + ((row0 + i) * H + hd) * P + 2 * t;
#pragma unroll
    for (int cc = 0; cc < kMaxP / 8; ++cc)
      if (cc < n_pt && 8 * cc + 2 * t < P)   // P is a multiple of 4
        store2(yr + 8 * cc, acc[cc][2 * r], acc[cc][2 * r + 1]);
  }
}

// Pass 2: one thread per (b, h, p, n) element of the state walks the
// chunks in order; every chunk's contribution and decay are loaded a batch
// ahead of the dependent updates
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ decay, T* __restrict__ h_out,
                      int n_bh, int PN, int nc) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPassThreads +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(n_bh) * PN) return;
  const size_t bh = idx / PN, e = idx % PN;
  float* st = states + bh * nc * PN + e;
  const float* dec = decay + bh * nc;
  float h = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float u[kPassBatch], d[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      const bool ok = c0 + i < nc;
      u[i] = ok ? st[static_cast<size_t>(c0 + i) * PN] : 0.f;
      d[i] = ok ? dec[c0 + i] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) st[static_cast<size_t>(c0 + i) * PN] = h;
      h = h * d[i] + u[i];
    }
  }
  store1(h_out + idx, h);
}

template <typename T, int NT>
int launch_t(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, void* h_out, float* states,
             float* decay, int B, int S, int H, int P, int N,
             cudaStream_t stream) {
  const int nc = (S + kQ - 1) / kQ;
  auto pass1 = ssd_chunk_kernel<T, false, NT>;
  auto pass3 = ssd_chunk_kernel<T, true, 1>;   // NT is pass 1's alone
  const size_t smem1 = sizeof(float) * Layout(P, N, false).floats(false);
  const size_t smem3 = sizeof(float) * Layout(P, N, true).floats(true);
  cudaError_t e = cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pass3,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const int blocks = B * nc * H;
  pass1<<<blocks, kThreads, smem1, stream>>>(xt, dt, A, bt, ct, nullptr,
                                             states, decay, S, H, P, N, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int PN = P * N;
  const long long elems = static_cast<long long>(B) * H * PN;
  ssd_state_pass_kernel<T><<<
      static_cast<unsigned>((elems + kPassThreads - 1) / kPassThreads),
      kPassThreads, 0, stream>>>(states, decay, static_cast<T*>(h_out),
                                 B * H, PN, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pass3<<<blocks, kThreads, smem3, stream>>>(xt, dt, A, bt, ct,
                                             static_cast<T*>(y), states,
                                             decay, S, H, P, N, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const float* dt, const float* A, const void* Bm,
             const void* Cm, void* y, void* h_out, float* states,
             float* decay, int B, int S, int H, int P, int N,
             cudaStream_t st) {
#define ARGS x, dt, A, Bm, Cm, y, h_out, states, decay, B, S, H, P, N, st
  if (N <= 16) return launch_t<T, 2>(ARGS);
  if (N <= 32) return launch_t<T, 4>(ARGS);
  if (N <= 64) return launch_t<T, 8>(ARGS);
  return launch_t<T, kMaxN / 8>(ARGS);
#undef ARGS
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, y and the final state alike);
// dt (B, S, H) and A (H,) are float32. P <= 64 and N <= 128, both
// multiples of 4; x, B and C 16-byte aligned. states (B, H, nc, P, N) and
// decay (B, H, nc), nc = ceil(S / 64), are f32 scratch. Returns the first
// launch error (cudaError_t).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* h_out, void* states,
                 void* decay, int B, int S, int H, int P, int N, int dtype,
                 void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (P < 4 || P > kMaxP || P % 4 || N < 4 || N > kMaxN || N % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  if (dtype == 0)
    return launch_n<float>(x, d, a, Bm, Cm, y, h_out, sts, dec, B, S, H, P,
                           N, st);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, d, a, Bm, Cm, y, h_out, sts, dec, B, S,
                                   H, P, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
