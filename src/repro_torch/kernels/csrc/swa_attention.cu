// Causal sliding-window flash attention for Hopper (sm_90a), the scoring /
// training forward of every attention layer:
//   out[bh, i] = sum_j softmax_j(q[bh, i] . k[bh, j] * scale) v[bh, j]
// over the keys j with 0 <= i - j < window (window = S: full causal).
//
// Replaces the TPU kernel repro/kernels/swa_attention.py::
// swa_attention_pallas (body _kernel, tile map _kv_block_index), which walks
// the KV tiles that meet each query block's band with an online softmax.
// Only the causal mode is ported: the reference's bidirectional mode never
// loads keys after a query block (_kv_block_index walks back from the
// block's last tile), so it is not the function its docstring names; the
// wrapper refuses causal=False.
//
// Layout: q, k, v, out (BH, S, D), heads folded into BH by the caller,
// row-major, D in {64, 128, 256}; q/k/v f32 or bf16 (one dtype), out in
// that dtype; f32 inside.
//
// Design. One block of 256 threads (a 16 x 16 grid) per (bh, 64-row query
// tile). The query tile goes to shared memory as f32 once; the block then
// visits only the 64-key tiles that meet its band, (q0 - window, q0 + 63],
// in order. Per tile:
//   1. K and V tiles to shared memory as f32 (16-byte loads, rows >= S are
//      zeros);
//   2. scores: each thread a 4 x 4 register tile (rows ty + 16i, keys
//      tx + 16j) of (q . k) * scale over D from shared memory; a masked
//      pair (outside the band, or a key >= S) gets -1e30, as in the
//      reference;
//   3. online softmax: four threads a row take the tile's row max,
//      m_new = max(m, tile max), p = exp(s - m_new) with masked p set to an
//      exact 0, l = l * exp(m - m_new) + sum p;
//   4. acc = acc * exp(m - m_new) + p . V, each thread holding 4 rows x
//      D / 16 columns of the f32 accumulator in registers.
// At the end out = acc / max(l, 1e-30), rounded once to the output dtype.
// Tiles are 64 x 64 whatever D; the reference's 128 blocks are a TPU
// BlockSpec choice. Blocks with later query tiles (more keys when the band
// is wide) are launched first.
//
// Bound on the H100: the function reads q, k, v once and writes out once,
// 4 * BH * S * D elements, and does ~4 D f32 operations per visible
// (query, key) pair. At Hymba's scoring shape (BH = 50, S = 2048, D = 64,
// f32, window 1024) that is 105 MB (31 us at 3.35 TB/s) against 20 GFLOP
// (0.30 ms at 67 TFLOP/s): bound by the f32 operations. This first kernel
// runs them on the FMA pipes from shared memory (no tensor cores).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kQB = 64;         // query rows of a block
constexpr int kKB = 64;         // keys of a tile
constexpr int kPLd = kKB + 4;   // row stride of the score tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows [row0, row0 + 64) of one (S, D) head into a (64, D + 4) f32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  constexpr int kPerRow = D / 4;
  for (int idx = threadIdx.x; idx < kQB * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) val = load4(src + static_cast<size_t>(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = val;
  }
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int window,
                                        int S) {
  const int d = q_pos - k_pos;
  return d >= 0 && d < window && k_pos < S;
}

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kQB) * (D + 4) * 3 + kQB * kPLd + 3 * kQB;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int n_qt, int window, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCW = D / 64;   // float4 columns a thread owns in p.V
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kQB * kLd;
  float* v_s = k_s + kKB * kLd;
  float* p_s = v_s + kKB * kLd;
  float* m_s = p_s + kQB * kPLd;
  float* l_s = m_s + kQB;
  float* c_s = l_s + kQB;

  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kQB;   // long rows first
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<T, D>(q_s, q + base, q0, S);
  if (tid < kQB) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kCW][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCW; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;

  // the key tiles that meet the band of rows [q0, last_q]
  const int last_q = min(q0 + kQB, S) - 1;
  const int t_lo = max(0, q0 - window + 1) / kKB, t_hi = last_q / kKB;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kKB;
    __syncthreads();   // the previous tile's K, V and p are consumed
    load_tile<T, D>(k_s, k + base, k0, S);
    load_tile<T, D>(v_s, v + base, k0, S);
    __syncthreads();

    // 2. scores, rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        p_s[r * kPLd + c] =
            visible(q0 + r, k0 + c, window, S) ? s[i][j] * scale : kNegInf;
      }
    __syncthreads();

    // 3. online softmax: four threads a row, keys part + 4 * kk
    {
      const int r = tid / 4, part = tid % 4;
      float* row = p_s + r * kPLd;
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kKB / 4; ++kk) mx = fmaxf(mx, row[part + 4 * kk]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKB / 4; ++kk) {
        const int c = part + 4 * kk;
        const float p = visible(q0 + r, k0 + c, window, S)
                            ? expf(row[c] - m_new) : 0.f;
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // 4. acc = acc * corr + p . V, rows ty + 16i, columns 4tx + 64c + e
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCW; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
#pragma unroll 2
    for (int j = 0; j < kKB; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPLd + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < kCW; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (j + jj) * kLd + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = get(pr[i], jj);
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
    }
  }

  // out = acc / max(l, 1e-30); l_s was last written before the final
  // barrier of the tile loop
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* o = out + base + static_cast<size_t>(q0 + r) * D;
#pragma unroll
    for (int c = 0; c < kCW; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(o + 4 * tx + 64 * c + e, acc[i][c][e] / l);
  }
}

template <typename T, int D>
int launch_t(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int window, float scale, cudaStream_t stream) {
  auto kern = swa_attention_kernel<T, D>;
  const size_t smem = sizeof(float) * smem_floats<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + kQB - 1) / kQB;
  kern<<<BH * n_qt, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, n_qt, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int D, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 64: return launch_t<T, 64>(q, k, v, out, BH, S, window, scale, st);
    case 128: return launch_t<T, 128>(q, k, v, out, BH, S, window, scale, st);
    case 256: return launch_t<T, 256>(q, k, v, out, BH, S, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). q, k, v and
// out must be 16-byte aligned. window >= 1 (window >= S: full causal).
// Returns the launch's cudaError_t.
int swa_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      int BH, int S, int D, int window, float scale,
                      int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (window < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, BH, S, D, window, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, BH, S, D, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swa_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
