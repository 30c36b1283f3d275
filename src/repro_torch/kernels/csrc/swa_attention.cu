// Causal sliding-window flash attention for Hopper (sm_90a), the scoring /
// training forward of every attention layer:
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale)
//                  v[b, j, h / G]
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
// Layout: the model's own. q and out are (B, S, H, D), k and v (B, S, KV, D),
// all row-major and contiguous, G = H / KV: query head h reads kv head
// h / G in place, from the row strides H * D and KV * D, so the caller
// neither repeats K and V over the query groups nor folds the heads. The
// folded (BH, S, D) entry is the same kernel with B = BH and H = KV = 1.
// D in {64, 120, 128, 240, 256}; q/k/v f32 or bf16 (one dtype), out in
// that dtype; f32 inside.
//
// D = 240 (gemma3-12b: d_model 3840 over 16 heads) and D = 120
// (h2o-danube-3-4b: 3840 over 32) are instantiations of their own, not a
// zero-pad to 256 or 128: wgmma.m64nNk8 takes N = 240 or 120 (multiples of
// 8) for P V, Q K^T steps through D in 8-wide slices (30 or 15 of them),
// and a row is 60 or 30 16-byte chunks (30 or 15 in bf16), so the tiles,
// the core-matrix planes and the GQA read in place stay as at D = 256 and
// 128, with their 16-key tiles. Only the copy and staging loops need a
// bound check, since 16 rows of those chunks are not a multiple of the
// block's 128 threads; a head's offset h D stays a multiple of 16 bytes
// (480 bytes at D = 120 in f32, 240 in bf16).
//
// Design. One block, one warpgroup (four warps, 16 query rows each), per
// (b, h, 64-row query tile). The block visits only the key tiles (32 keys
// at D = 64, 16 above, so that three blocks share an SM at D = 64) that
// meet its band, (q0 - window, q0 + 63], in order. Per tile:
//   0. the tile's K and V, copied as stored by cp.async while the previous
//      tile ran, become TF32 operand planes in shared memory in wgmma's
//      core-matrix layout (8 rows x 16 bytes, no swizzle, K-major as tf32
//      wgmma requires): K as stored, V transposed; hi and, for f32 inputs,
//      lo; then the raw buffers take the next tile's copy;
//   1. S = Q K^T by wgmma.m64nNk8 (N = the tile's keys), the A operand Q's
//      fragments from registers (read from shared memory and split), B the
//      K planes; a masked pair (outside the band, or a key >= S) gets
//      -1e30, as in the reference;
//   2. online softmax on the accumulator registers, in the log2 domain
//      (exp(s - m) = exp2(s log2e - m log2e)): the four lanes of a row take
//      its max by shuffles, m_new = max(m, tile max), p = exp2(s - m_new)
//      with masked p an exact 0, each lane keeps its part of l;
//   3. O = O * exp2(m - m_new) + P V by wgmma.m64nDk8, P straight from the
//      score registers: the accumulator's lanes hold keys (2t, 2t + 1) of
//      each 8-key group, and the V^T planes hold each group's keys in the
//      order (0, 2, 4, 6, 1, 3, 5, 7), so P needs no shuffle.
// At the end out = O / max(l, 1e-30), rounded once to the output dtype.
// A row whose first visited tile is all masked keeps m = -1e30 and l = 0
// (exp2(0) for the accumulator's correction, p = 0), with no NaN; rows
// past S are zeros and are not written. Within a block the steps run in
// turn (the tensor cores wait while it stages and takes the softmax);
// three blocks an SM at D = 64 (168 registers a thread, 68 KB of shared
// memory) fill each other's gaps.
//
// Precision. The check against the plain version is 1e-4 (1 + |ref|) in
// f32, which one TF32 pass (~11 bits) misses. f32 inputs therefore run
// 3xTF32: each operand splits into hi, its TF32 truncation (a mask), and
// lo = x - hi, exact, which the tensor core reads as TF32 in turn (it
// ignores a register's low 13 bits); lo.hi + hi.lo + hi.hi accumulate in
// f32 (lo.lo, ~2^-22 of the product, is dropped). bf16 values are exact in
// TF32, so a bf16 Q K^T is one exact product per pair; P (f32) still
// splits in two for P V.
//
// Bound on the H100: the function reads q, k, v once and writes out once
// (the kv heads once each: (2 H + 2 KV) B S D elements) and does 4 D
// multiply-add operations per visible (query, key) pair. At Hymba's scoring
// shape (B = 2, S = 2048, H = 25, KV = 5, D = 64, f32, window 1024) that is
// 63 MB (19 us at 3.35 TB/s) against 20.1 GFLOP: 0.30 ms at the f32 FMA
// rate (67 TFLOP/s), 0.12 ms as 3xTF32 on the tensor cores (3 x 20.1
// GFLOP at 495 TFLOP/s).
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// The launch goes on the caller's stream; the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32::AFrag;
using tf32::Split;
using tf32::Wgmma;
using tf32::cp_async16;
using tf32::split;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kQB = 64;         // query rows of a block, 16 a warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// keys of a tile: 32 at D = 64, 16 above, so that a block's buffers fit
// three blocks an SM at D = 64, two at 120 and 128 and one at 240 and 256
template <int D>
__host__ __device__ constexpr int key_tile() { return D == 64 ? 32 : 16; }

// Per dtype: the row pad of the tiles copied as stored (rows stay 16-byte
// aligned and the fragment reads fall on distinct banks), the elements of
// a 16-byte copy, and whether an operand needs a lo part (3xTF32)
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kPad = 4, kVec = 4;
  static constexpr bool kSplit = true;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPad = 8, kVec = 8;
  static constexpr bool kSplit = false;   // exact in TF32
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ROWS rows from row0 of one head (row stride ld elements) into a
// (ROWS, D + pad) tile by cp.async; rows >= S are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, size_t ld,
                                          int row0, int S) {
  constexpr int kVec = Elem<T>::kVec, kLd = D + Elem<T>::kPad;
  constexpr int kPerRow = D / kVec, kCopies = ROWS * kPerRow;
#pragma unroll
  for (int i = 0; i < (kCopies + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kCopies % kThreads && idx >= kCopies) break;
    const int r = idx / kPerRow, c = (idx % kPerRow) * kVec;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * kLd + c,
               src + static_cast<size_t>(ok ? row0 + r : 0) * ld + c, ok);
  }
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int window,
                                        int S) {
  const int d = q_pos - k_pos;
  return d >= 0 && d < window && k_pos < S;
}

// Shared memory: q (kQB rows) and the raw K and V tiles (kKB rows each) as
// stored, then the TF32 operand planes of the tile's products, each
// kKB x D f32 in core matrices: K (keys x d, for S = Q K^T) and V^T (d x
// keys, for O += P V), hi and, for f32 inputs, lo
template <typename T, int D>
struct Smem {
  static constexpr int kKB = key_tile<D>();
  static constexpr int kLd = D + Elem<T>::kPad;
  static constexpr int kPlanes = Elem<T>::kSplit ? 2 : 1;
  static constexpr size_t kRawBytes = sizeof(T) * (kQB + 2 * kKB) * kLd;
  // V^T's chunks of 4 keys sit 16 bytes apart beyond their core matrices,
  // so that the transposing writes of a warp fall on distinct banks
  static constexpr uint32_t kLboK = kKB / 8 * 128, kLboV = D / 8 * 128 + 16;
  static constexpr size_t kPlaneFloats = (kKB / 4 * kLboV / 4 + 31) / 32 * 32;
  static constexpr size_t kBytes =
      kRawBytes + sizeof(float) * 2 * kPlanes * kPlaneFloats;
  static_assert(kRawBytes % 128 == 0, "planes 128-byte aligned");
};

// K tile -> planes: element (key, d) of core matrix (key / 8, d / 4) at
// floats ((d / 4) (kKB / 8) + key / 8) 32 + (key % 8) 4 + d % 4: LBO (along
// d) kKB / 8 core matrices, SBO (along keys) one. V tile -> V^T planes:
// (d, key) of core matrix (d / 8, c), with the keys of each 8-key group j
// in the order the P fragment holds them, 2t in chunk 2j and 2t + 1 in
// chunk 2j + 1, position t: c = 2j + (key % 2), element (key % 8) / 2;
// LBO (along keys) D / 8 core matrices and 16 bytes, SBO (along d) one.
template <typename T, int D>
__device__ __forceinline__ void stage_planes(const T* k_raw, const T* v_raw,
                                             float* k_hi, float* k_lo,
                                             float* v_hi, float* v_lo) {
  constexpr int kKB = Smem<T, D>::kKB, kLd = Smem<T, D>::kLd;
  constexpr bool kSplit = Elem<T>::kSplit;
  constexpr int kItems = kKB * D / 4;
#pragma unroll
  for (int i = 0; i < (kItems + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (kItems % kThreads && idx >= kItems) break;
    const int key = idx % kKB, d4 = idx / kKB;   // neighbours: keys
    const float4 kv = load4(k_raw + key * kLd + 4 * d4);
    const int ko = (d4 * (kKB / 8) + key / 8) * 32 + (key % 8) * 4;
    if (kSplit) {
      const Split a = split(kv.x), b = split(kv.y), c = split(kv.z),
                  d = split(kv.w);
      *reinterpret_cast<uint4*>(k_hi + ko) = make_uint4(a.hi, b.hi, c.hi,
                                                        d.hi);
      *reinterpret_cast<uint4*>(k_lo + ko) = make_uint4(a.lo, b.lo, c.lo,
                                                        d.lo);
    } else {
      *reinterpret_cast<float4*>(k_hi + ko) = kv;
    }
    const float4 vv = load4(v_raw + key * kLd + 4 * d4);
    const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
    const int c = 2 * (key / 8) + (key % 2), e = (key % 8) / 2;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 4 * d4 + q;
      const int vo = c * (Smem<T, D>::kLboV / 4) + (d / 8) * 32 + (d % 8) * 4 +
                     e;
      if (kSplit) {
        const Split sv = split(ve[q]);
        v_hi[vo] = __uint_as_float(sv.hi);
        v_lo[vo] = __uint_as_float(sv.lo);
      } else {
        v_hi[vo] = ve[q];
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int H, int KV, int n_qt, int window, float scale) {
  using L = Smem<T, D>;
  constexpr bool kSplit = Elem<T>::kSplit;
  constexpr int kKB = L::kKB, kLd = L::kLd;
  constexpr int kNT = kKB / 8;   // 8-key groups of a tile
  constexpr int kDT = D / 8;     // 8-column groups of the output
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);   // (kQB, kLd)
  T* k_raw = q_s + kQB * kLd;             // (kKB, kLd)
  T* v_raw = k_raw + kKB * kLd;           // (kKB, kLd)
  float* k_hi = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + L::kRawBytes);
  float* k_lo = k_hi + L::kPlaneFloats;                 // f32 inputs only
  float* v_hi = k_hi + L::kPlanes * L::kPlaneFloats;
  float* v_lo = v_hi + L::kPlaneFloats;                 // f32 inputs only

  // blocks of one query tile run together, the G heads of a kv head side
  // by side (their K/V tiles stay in L2); the latest tiles (most keys when
  // the band is wide) first
  const int BH = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kQB;
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const size_t ldq = static_cast<size_t>(H) * D;
  const size_t ldk = static_cast<size_t>(KV) * D;
  const T* qb = q + static_cast<size_t>(b) * S * ldq +
                static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * S * ldk +
                static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * S * ldk +
                static_cast<size_t>(kvh) * D;
  T* ob = out + static_cast<size_t>(b) * S * ldq + static_cast<size_t>(h) * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * warp;   // the warp's first row
  const int row[2] = {w0 + g, w0 + g + 8};
  // scores in the log2 domain: exp(s - m) = exp2(s log2e - m log2e)
  const float scale2 = scale * kLog2e;
  constexpr uint32_t kLboK = L::kLboK, kLboV = L::kLboV;

  // the key tiles that meet the band of rows [q0, last_q]
  const int last_q = min(q0 + kQB, S) - 1;
  const int t_lo = max(0, q0 - window + 1) / kKB, t_hi = last_q / kKB;

  load_tile<T, D, kQB>(q_s, qb, ldq, q0, S);
  load_tile<T, D, kKB>(k_raw, kb, ldk, t_lo * kKB, S);
  load_tile<T, D, kKB>(v_raw, vb, ldk, t_lo * kKB, S);
  tf32::cp_commit();

  float o[D / 2];   // O: rows w0 + g, + 8, columns 8c + 2t, + 1
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int tile = t_lo; tile <= t_hi; ++tile) {
    // the tile's raw copy has landed and the last products are done with
    // the planes: rebuild them, then the raw buffers take the next tile
    tf32::cp_wait<0>();
    __syncthreads();
    stage_planes<T, D>(k_raw, v_raw, k_hi, k_lo, v_hi, v_lo);
    tf32::fence_async_smem();
    __syncthreads();
    if (tile < t_hi) {
      load_tile<T, D, kKB>(k_raw, kb, ldk, (tile + 1) * kKB, S);
      load_tile<T, D, kKB>(v_raw, vb, ldk, (tile + 1) * kKB, S);
      tf32::cp_commit();
    }
    const int k0 = tile * kKB;

    // 1. S = Q K^T on the tensor cores: lane (g, t) holds rows g, g + 8
    //    and keys 8j + 2t, + 1 in s[4j + e]
    float s[kKB / 2];
#pragma unroll
    for (int i = 0; i < kKB / 2; ++i) s[i] = 0.f;
    tf32::wg_fence();
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      const T* qr = q_s + (16 * warp + g) * kLd + kk + t;
      const float qv[4] = {to_f(qr[0]), to_f(qr[8 * kLd]), to_f(qr[4]),
                           to_f(qr[8 * kLd + 4])};
      const AFrag<kSplit> a(qv);
      const int off = kk / 4 * (kKB / 8) * 32;
      const uint64_t dk = tf32::smem_desc(k_hi + off, kLboK, 128);
      if (kSplit) {
        const uint64_t dl = tf32::smem_desc(k_lo + off, kLboK, 128);
        Wgmma<kKB>::run(s, a.lo, dk, 1);
        Wgmma<kKB>::run(s, a.hi, dl, 1);
        Wgmma<kKB>::run(s, a.hi, dk, 1);
      } else {
        Wgmma<kKB>::run(s, a.hi, dk, 1);
      }
    }
    tf32::wg_commit();
    tf32::wg_wait<0>();
    tf32::fence_regs(s);

    // 2. mask, online softmax in the log2 domain
    const bool full = k0 + kKB - 1 <= w0 && w0 + 15 - k0 < window &&
                      k0 + kKB <= S;   // every pair of the warp visible
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale2;
        if (!full && !visible(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1),
                              window, S))
          x = kNegInf;
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked pair's score is exactly -1e30: its p is an exact 0
        const float x = s[4 * j + e];
        const float p = x == kNegInf ? 0.f : exp2f(x - m[e >> 1]);
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // 3. O += P V on the tensor cores; the A fragment of 8-key group j is
    //    (p[g][2t], p[g+8][2t], p[g][2t+1], p[g+8][2t+1]), which the V^T
    //    planes hold in that key order
    tf32::wg_fence();
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float pv[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1],
                           s[4 * j + 3]};
      const AFrag<true> pa(pv);
      const int off = 2 * j * (kLboV / 4);
      const uint64_t dv = tf32::smem_desc(v_hi + off, kLboV, 128);
      Wgmma<D>::run(o, pa.lo, dv, 1);
      if (kSplit)
        Wgmma<D>::run(o, pa.hi, tf32::smem_desc(v_lo + off, kLboV, 128), 1);
      Wgmma<D>::run(o, pa.hi, dv, 1);
    }
    tf32::wg_commit();
    tf32::wg_wait<0>();
    tf32::fence_regs(o);
  }

  // out = O / max(l, 1e-30): the row's l is the sum of its four lanes'
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    if (row[r] >= S) continue;
    T* orow = ob + static_cast<size_t>(row[r]) * ldq + 2 * t;
#pragma unroll
    for (int c = 0; c < kDT; ++c)
      store2(orow + 8 * c, o[4 * c + 2 * r] / l[r],
             o[4 * c + 2 * r + 1] / l[r]);
  }
}

template <typename T, int D>
int launch_t(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int window, float scale,
             cudaStream_t stream) {
  auto kern = swa_attention_kernel<T, D>;
  constexpr size_t smem = Smem<T, D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (S + kQB - 1) / kQB;
  kern<<<B * H * n_qt, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, n_qt, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int H, int KV, int D, int window, float scale,
             cudaStream_t st) {
#define ARGS q, k, v, out, B, S, H, KV, window, scale, st
  switch (D) {
    case 64: return launch_t<T, 64>(ARGS);
    case 120: return launch_t<T, 120>(ARGS);
    case 128: return launch_t<T, 128>(ARGS);
    case 240: return launch_t<T, 240>(ARGS);
    case 256: return launch_t<T, 256>(ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ARGS
}

}  // namespace

extern "C" {

// q, out (B, S, H, D); k, v (B, S, KV, D); H a multiple of KV. dtype:
// 0 = float32, 1 = bfloat16 (q, k, v and out alike). q, k, v and out must
// be 16-byte aligned. window >= 1 (window >= S: full causal). Returns the
// launch's cudaError_t.
int swa_attention_fwd(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int KV, int D, int window,
                      float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (window < 1 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, S, H, KV, D, window, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, window,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* swa_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
