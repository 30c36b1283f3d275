// One-token GQA decode attends for Hopper (sm_90a): the ring attend of the
// sliding-window layers and the extent attend of the full-attention layers.
//
// Replaces the TPU kernels repro/kernels/swa_attention.py::
//   ring_decode_attend_pallas   (body _ring_decode_kernel)
//   extent_decode_attend_pallas (body _extent_decode_kernel)
// which share the attend body _decode_attend and the mask _window_bias.
// Here both kernels are one template over RING, sharing one device body.
//
// For each row b (its own position p = pos[b]) and each kv head, over L
// keys:
//   ring:   L = W slots, slot s holds position p - floormod(p - s, W)
//           (negative = never written, masked);
//   extent: L = k_ext, key s holds position s, masked beyond p.
// With the window mask (window 0 = full) the keys a row sees are always one
// run of positions: the ring's latest min(window, W, p + 1) positions,
// position x in slot x mod W; the extent's max(0, p + 1 - window) ...
// min(p, k_ext - 1). f32 scores (q.k) * scale, a softmax over the visible
// keys, p.V accumulated in f32, the output written in q's dtype.
//
// Design: one launch a call, one cluster of C thread blocks of four warps
// per (row, kv head), C = ceil(L / 64) capped at 16 (Hopper's non-portable
// cluster size). Every block holds the G query heads of its kv head, so
// each K and V element is read once, by one warp.
//   1. The row's visible positions are split evenly over the C blocks, and
//      each block's over its four warps (warp w of block r takes an even
//      share of [lo + r n / C, lo + (r + 1) n / C) of the n visible ones):
//      no block or warp holds masked keys. Masked keys are never read.
//   2. Each warp requests its share at once, in tiles of 8 keys: cp.async
//      copies (16 bytes where the rows allow it) of the tile's K and of its
//      V, in separate commit groups, into the warp's own ring of kStages =
//      3 stages. At Hymba's decode shape a warp's whole ring share (16 keys)
//      and 24 of its extent share (at most 32) are in flight from the
//      start, and V's bytes travel while the scores and the softmax are
//      formed. A stage is refilled with the tile kStages ahead once used.
//      The warps never wait for each other until the end. q is read before
//      the row's position, so its load overlaps that one, and the copy loop
//      steps its (row, chunk) indices without a division.
//   3. Per tile, on the tensor cores (mma.sync.m16n8k8, TF32): S = Q K^T
//      for the 16 rows of a zero-padded Q (G heads) and the tile's 8 keys,
//      alternate 8-wide slices of D in two accumulators;
//      an online softmax on the score registers (running max m and sum l
//      a row, the rescale exp(m_old - m_new) applied to the output
//      registers); O += P V with P straight from the score registers (the
//      lane holding keys 2t, 2t + 1 of a row supplies the A fragment's k
//      and k + 4, and V's rows are read in that order). f32 operands run
//      3xTF32 (hi, lo = x - hi; lo.hi + hi.lo + hi.hi), the error of one
//      product ~2^-22 relative; bf16 values are exact in TF32.
//   4. The block combines its four warps (rescaled to the block's max, in
//      warp order) and publishes its max, sum and partial p.V; the cluster
//      combines once, through distributed shared memory: each block reads
//      every rank's maxima and sums, forms the cluster's max M, each rank's
//      factor exp(m_r - M) and the total sum in rank order, then writes its
//      share of the outputs from all C partials read at once. A row that
//      sees no key at all (never the case in serving, where the current
//      token is visible) writes zeros.
// Nothing in shared memory grows with L: a warp keeps kStages tiles, a
// block Q and its partial, so any number of keys runs.
//
// Precision. The reference takes the max over all keys, divides after the
// sum, rounds p = e / sum to q's dtype, then sums p.V in f32. Here the sum
// of e v is divided once at the end, and the maxima are combined as the
// tiles, warps and blocks go, so exp(s - M) is formed as exp(s - m)
// exp(m - M). For f32 q that is the same function up to the order of f32
// operations and 3xTF32's ~2^-22, within SERVE_TOL["f32"] = 2e-5 (1 + |ref|).
// For bf16 q this kernel does not round p to bf16 before p.V: the
// difference is at most 2^-9 of sum_j p_j |v_j| before the output's own
// bf16 rounding, and the bf16 cases are held at SERVE_TOL["bf16"] =
// 1e-2 (1 + |ref|), as before the redesign (chip_smoke.py phase 7,
// tests/test_torch_cuda.py).
//
// Bound on the H100: the function must read the visible keys' K and V,
// 2 * n_visible * D elements a (row, kv head), q, and write B * KV * G * D.
// At Hymba's decode shape (B = 4, KV = 5, G = 5, D = 64, f32) the ring with
// every slot visible reads ~10.5 MB (3.1 us at 3.35 TB/s); ~4 f32
// operations a (head, key, dim) are far below even the FMA rate:
// memory-bound. 20 clusters of 16 blocks (320 blocks of 128 threads, three
// an SM) keep the whole ring in flight.
//
// Limits: D <= 256, G <= 16 (the wrapper checks both); any L.
//
// Plain C interface, loaded with ctypes (repro_torch/kernels/build.py).
// Launches go on the caller's stream; each entry returns the launch's
// cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using tf32::AFrag;
using tf32::mma_b;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 16;    // blocks of a (row, kv head), at most
constexpr int kKeysPerBlock = 64;  // C = ceil(L / kKeysPerBlock) blocks
constexpr int kTile = 8;           // keys of a warp's tile: one n8 product
constexpr int kStages = 3;         // tiles in flight a warp
constexpr int kRows = 16;          // Q's rows: G heads, zero-padded
constexpr int kMaxG = 16;
constexpr int kMaxD = 256;
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

// global -> shared, `bytes` of 16, 8 or 4 by cp.async; 2 (bf16 rows of odd
// D) by a plain load and store, which the warp barrier after the wait
// covers
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

// The run of positions row position p sees: n (>= 0) of them from lo
template <bool RING>
__device__ __forceinline__ void visible_run(int p, int L, int window,
                                            int& lo, int& n) {
  const int w_eff = window == 0 ? (1 << 30) : window;
  if (RING) {
    n = min(min(w_eff, L), p + 1);
    lo = p - n + 1;
  } else {
    lo = max(0, p - w_eff + 1);
    n = min(p, L - 1) - lo + 1;
  }
  n = max(n, 0);
}

// Grid: B * KV clusters of C blocks of kThreads (C from the launch); NT =
// ceil(D / 8) <= kNT column groups. k/v: key s of row b, head kv at
// k + b * batch_stride + (s * KV + kv) * D. Shared memory: the warps'
// stages (kWarps x kStages x {K tile, V tile}, kTile rows of ld bytes),
// later the warps' partials (kWarps x 16 x 8 NT f32); Q as f32 (16 rows of
// ldq bytes, zeros beyond G and D), later the block's partial (G x D);
// then the statistics.
template <typename QT, typename KT, bool RING, int kNT>
__global__ void __launch_bounds__(kThreads)
decode_attend_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                     const KT* __restrict__ v, const int* __restrict__ pos,
                     QT* __restrict__ out, int KV, int G, int D, int L,
                     long long batch_stride, int window, float scale, int ld,
                     int ldq, int region0, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kSplitK = sizeof(KT) == 4;   // f32 K/V: 3xTF32
  constexpr bool kSplitQ = sizeof(QT) == 4 || kSplitK;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int NT = (D + 7) / 8;
  const int ldqf = ldq / 4;                    // floats a Q row
  float* qs = reinterpret_cast<float*>(smem + region0);
  float* part = qs;                            // after the warps' loops
  float* wm = qs + kRows * ldqf;               // kWarps x 16: warp maxima
  float* wl = wm + kWarps * kRows;             // kWarps x 16: warp sums
  float* st = wl + kWarps * kRows;             // G maxima, G sums, G totals
  float* fac = st + 3 * G;                     // C x G: the ranks' maxima
  float* lsum = fac + kMaxCluster * G;         // C x G: their sums
  float* fw = lsum + kMaxCluster * G;          // C x G: their factors

  const int head_id = blockIdx.x / C;
  const int b = head_id / KV, kv = head_id % KV;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;       // fragment row, column

  // Q's elements, read before anything waits on pos; stored to shared
  // memory as f32, zero-padded to 16 rows and 8 NT columns, once the
  // copies are on their way
  constexpr int kQPer = (kRows * 8 * kNT + kThreads - 1) / kThreads;
  const int Dp = 8 * NT;
  const QT* qb = q + static_cast<size_t>(head_id) * G * D;
  float qv[kQPer];
  const int qr0 = tid / Dp, qc0 = tid % Dp;   // element tid + u kThreads
  const int qdr = kThreads / Dp, qdc = kThreads % Dp;
  {
    int r = qr0, c = qc0;
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      qv[u] = r < G && c < D ? to_f32(qb[r * D + c]) : 0.f;
      r += qdr;
      c += qdc;
      if (c >= Dp) {
        c -= Dp;
        ++r;
      }
    }
  }

  // 1. this warp's share of the row's visible positions, [x0, x1)
  int lo, n;
  visible_run<RING>(pos[b], L, window, lo, n);
  const long long n_vis = static_cast<long long>(n);
  const int share = rank * kWarps + warp, shares = C * kWarps;
  const int x0 = lo + static_cast<int>(n_vis * share / shares);
  const int x1 = lo + static_cast<int>(n_vis * (share + 1) / shares);
  const int n_tiles = (x1 - x0 + kTile - 1) / kTile;

  const size_t kstride = static_cast<size_t>(KV) * D;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      k + b * batch_stride + static_cast<size_t>(kv) * D);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      v + b * batch_stride + static_cast<size_t>(kv) * D);
  const int chunks = D * static_cast<int>(sizeof(KT)) / chunk;  // a row
  unsigned char* wst = smem + warp * kStages * 2 * kTile * ld;
  // copy j = lane + 32 u of a tile is chunk c of its row r, stepped
  // without a division: the copies are issued on the critical path
  const int r_lane = lane / chunks, c_lane = lane % chunks;
  const int dr = 32 / chunks, dc = 32 % chunks;

  // 2. tile i of K, then of V, into the warp's stage i % kStages: two
  // commit groups whatever i, so that the waits below count the same
  auto issue = [&](int i) {
    unsigned char* ks = wst + (i % kStages) * 2 * kTile * ld;
    const int t0 = x0 + i * kTile, nt = min(kTile, x1 - t0);
    const int slot0 = RING && i < n_tiles ? t0 % L : t0;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      if (i < n_tiles) {
        const unsigned char* src = which ? vb : kb;
        unsigned char* dst = ks + which * kTile * ld;
        int r = r_lane, c = c_lane;
        for (int j = lane; j < nt * chunks; j += 32) {
          int slot = slot0 + r;          // the ring wraps at most once a
          if (RING && slot >= L) slot -= L;   // tile when L >= kTile ...
          if (RING && slot >= L) slot %= L;   // ... and any times below
          copy_chunk(dst + r * ld + c * chunk,
                     src + (static_cast<size_t>(slot) * kstride) *
                               sizeof(KT) + c * chunk,
                     chunk);
          r += dr;
          c += dc;
          if (c >= chunks) {
            c -= chunks;
            ++r;
          }
        }
      }
      tf32::cp_commit();
    }
  };
#pragma unroll 1
  for (int i = 0; i < kStages; ++i) issue(i);

  {
    int r = qr0, c = qc0;
#pragma unroll
    for (int u = 0; u < kQPer; ++u) {
      if (r < kRows) qs[r * ldqf + c] = qv[u];
      r += qdr;
      c += qdc;
      if (c >= Dp) {
        c -= Dp;
        ++r;
      }
    }
  }
  __syncthreads();

  // 3. the warp's tiles: rows g and g + 8 of S, O and the statistics
  float o[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int ldk = ld / static_cast<int>(sizeof(KT));   // elements a row
#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const KT* kt = reinterpret_cast<const KT*>(
        wst + (i % kStages) * 2 * kTile * ld);
    const KT* vt = kt + kTile * ldk;
    const int nt = min(kTile, x1 - x0 - i * kTile);
    tf32::cp_wait<2 * kStages - 1>();   // this lane's K copies have landed
    __syncwarp();                       // and every lane's are visible

    // S = Q K^T: lane (g, t) holds rows g, g + 8 and keys 2t, 2t + 1;
    // alternate 8-wide slices of D go to two accumulators (two chains of
    // dependent products instead of one)
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = qs + g * ldqf;
    const KT* kr = kt + g * ldk;         // key g of the tile
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      if (kk < NT) {
        const int d0 = 8 * kk + t, d1 = d0 + 4;
        const float qa[4] = {qr[d0], qr[8 * ldqf + d0], qr[d1],
                             qr[8 * ldqf + d1]};
        const AFrag<kSplitQ> a(qa);
        const float b0 = d0 < D ? to_f32(kr[d0]) : 0.f;
        const float b1 = d1 < D ? to_f32(kr[d1]) : 0.f;
        if (kk % 2)
          mma_b<kSplitK, kSplitQ>(s2, a, b0, b1);
        else
          mma_b<kSplitK, kSplitQ>(s, a, b0, b1);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += s2[e];
    // online softmax; keys past the tile's nt (stale rows) are masked
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[2 * r + e];
        x = 2 * t + e < nt ? x * scale : kNegInf;
      }
      float mx = fmaxf(s[2 * r], s[2 * r + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[2 * r + e];
        x = x == kNegInf ? 0.f : expf(x - m_new);
        sum += x;
      }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
    }
    // O += P V: the A fragment's (row, k) and (row, k + 4) are keys 2t and
    // 2t + 1, so V's rows 2t and 2t + 1 are the B fragment's k and k + 4
    const float pa[4] = {s[0], s[2], s[1], s[3]};
    const AFrag<true> p(pa);
    tf32::cp_wait<2 * kStages - 2>();   // this tile's V has landed
    __syncwarp();
    const KT* v0 = vt + (2 * t) * ldk;
    const KT* v1 = v0 + ldk;
    const bool ok0 = 2 * t < nt, ok1 = 2 * t + 1 < nt;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j < NT) {
        const int d = 8 * j + g;
        const float b0 = ok0 && d < D ? to_f32(v0[d]) : 0.f;
        const float b1 = ok1 && d < D ? to_f32(v1[d]) : 0.f;
        mma_b<kSplitK, true>(o[j], p, b0, b1);
      }
    }
    __syncwarp();                       // the stage is free
    issue(i + kStages);
  }

  // 4a. the block's partial: the warps' rescaled to the block's max
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (t == 0) {
    wm[warp * kRows + g] = m[0];
    wm[warp * kRows + g + 8] = m[1];
    wl[warp * kRows + g] = l[0];
    wl[warp * kRows + g + 8] = l[1];
  }
  __syncthreads();                      // the stages are free: partials
  float* pw = reinterpret_cast<float*>(smem);   // kWarps x 16 x 8 NT
  const int ldp = 8 * NT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float M = kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kRows + row]);
    const float f = expf(m[r] - M);    // 0 for a warp without keys
    float* dst = pw + (warp * kRows + row) * ldp + 2 * t;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j < NT) {
        dst[8 * j] = o[j][2 * r] * f;
        dst[8 * j + 1] = o[j][2 * r + 1] * f;
      }
    }
  }
  if (tid < G) {
    float mw[kWarps], M = kNegInf, lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wm[w * kRows + tid];
      M = fmaxf(M, mw[w]);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      lt += wl[w * kRows + tid] * expf(mw[w] - M);
    st[tid] = M;
    st[G + tid] = lt;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int row = i / D, d = i % D;
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += pw[(w * kRows + row) * ldp + d];
    part[i] = acc;
  }

  // 4b. the cluster: every block reads every rank's maxima and sums, then
  // forms the cluster's max M, each rank's factor exp(m_r - M) and the
  // total sum in rank order
  cluster.sync();
  for (int i = tid; i < C * G; i += kThreads) {
    const float* sr = cluster.map_shared_rank(st, i / G);
    fac[i] = sr[i % G];
    lsum[i] = sr[G + i % G];
  }
  __syncthreads();
  // thread r G + g: rank r's factor for head g; then head g's sum
  for (int i = tid; i < C * G; i += kThreads) {
    const int hg = i % G;
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) M = fmaxf(M, fac[r * G + hg]);
    fw[i] = expf(fac[i] - M);           // 0 for a rank without keys
    lsum[i] *= fw[i];
  }
  __syncthreads();
  if (tid < G) {
    float lt = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) lt += lsum[r * G + tid];
    st[2 * G + tid] = lt;   // other blocks read only st[0, 2 G) and part
  }
  __syncthreads();
  // the partials: all C remote reads of an output issued before any sum
  QT* ob = out + static_cast<size_t>(head_id) * G * D;
  for (int i = rank * kThreads + tid; i < G * D; i += C * kThreads) {
    const int hg = i / D;
    float pr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      pr[r] = r < C ? cluster.map_shared_rank(part, r)[i] : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) acc += pr[r] * fw[r * G + hg];
    const float lt = st[2 * G + hg];
    ob[i] = from_f32<QT>(lt > 0.f ? acc / lt : 0.f);
  }
  cluster.sync();   // no block leaves while another still reads its smem
}

// bytes of a shared row of `bytes` payload: a multiple of 16 that is 16
// more than a multiple of 128, so that the fragment reads of the 8 rows
// (or 4 row pairs) a warp touches fall on distinct banks
__host__ int padded_row(int bytes) {
  int ld = (bytes + 15) / 16 * 16;
  while (ld % 128 != 16) ld += 16;
  return ld;
}

template <typename QT, typename KT, bool RING, int kNT>
int launch_t(const void* q, const void* k, const void* v, const int* pos,
             void* out, int B, int KV, int G, int D, int L,
             long long batch_stride, int window, float scale, int chunk,
             cudaStream_t stream) {
  auto kern = decode_attend_kernel<QT, KT, RING, kNT>;
  const int ld = padded_row(D * static_cast<int>(sizeof(KT)));
  const int Dp = 8 * ((D + 7) / 8);
  const int ldq = padded_row(4 * Dp);
  const int region0 = std::max(kWarps * kStages * 2 * kTile * ld,
                               kWarps * kRows * Dp * 4);
  const int C = std::min(kMaxCluster,
                         std::max(1, (L + kKeysPerBlock - 1) / kKeysPerBlock));
  const size_t smem =
      region0 + static_cast<size_t>(kRows) * ldq +
      sizeof(float) * (2 * kWarps * kRows + 3 * G + 3 * kMaxCluster * G);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), pos, static_cast<QT*>(out), KV, G, D, L,
      batch_stride, window, scale, ld, ldq, region0, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the output's 8-column groups, NT = ceil(D / 8), rounded up to a power of
// two: an instantiation holds 4 kNT accumulators a lane
template <typename QT, typename KT, bool RING>
int launch_d(const void* q, const void* k, const void* v, const int* pos,
             void* out, int B, int KV, int G, int D, int L,
             long long batch_stride, int window, float scale, int chunk,
             cudaStream_t st) {
#define ARGS q, k, v, pos, out, B, KV, G, D, L, batch_stride, window, scale, \
             chunk, st
  const int NT = (D + 7) / 8;
  if (NT <= 2) return launch_t<QT, KT, RING, 2>(ARGS);
  if (NT <= 4) return launch_t<QT, KT, RING, 4>(ARGS);
  if (NT <= 8) return launch_t<QT, KT, RING, 8>(ARGS);
  if (NT <= 16) return launch_t<QT, KT, RING, 16>(ARGS);
  return launch_t<QT, KT, RING, 32>(ARGS);
#undef ARGS
}

template <bool RING>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int KV, int G, int D, int L,
           long long batch_stride, int window, float scale, int q_dtype,
           int kv_dtype, int chunk, void* stream) {
  if (B <= 0) return 0;
  const int kv_size = kv_dtype == 1 ? 2 : 4;
  if (D < 1 || D > kMaxD || G < 1 || G > kMaxG || L < 1 || KV < 1 ||
      (chunk != 2 && chunk != 4 && chunk != 8 && chunk != 16) ||
      (kv_size == 4 && chunk == 2) || (D * kv_size) % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, p, out, B, KV, G, D, L, batch_stride, window, scale, \
             chunk, st
  if (q_dtype == 0 && kv_dtype == 0)
    return launch_d<float, float, RING>(ARGS);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_d<float, bf16, RING>(ARGS);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch_d<bf16, float, RING>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_d<bf16, bf16, RING>(ARGS);
#undef ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. chunk: the bytes of one copy,
// 16, 8, 4 or (bf16 only) 2, dividing the D elements of a row and the
// alignment of k and v. Returns the launch's cudaError_t.
int ring_decode_attend_fwd(const void* q, const void* k, const void* v,
                           const void* pos, void* out, int B, int W, int KV,
                           int G, int D, int window, float scale,
                           int q_dtype, int kv_dtype, int chunk,
                           void* stream) {
  return launch<true>(q, k, v, pos, out, B, KV, G, D, W,
                      static_cast<long long>(W) * KV * D, window, scale,
                      q_dtype, kv_dtype, chunk, stream);
}

int extent_decode_attend_fwd(const void* q, const void* k, const void* v,
                             const void* pos, void* out, int B, int S_max,
                             int k_ext, int KV, int G, int D, int window,
                             float scale, int q_dtype, int kv_dtype,
                             int chunk, void* stream) {
  return launch<false>(q, k, v, pos, out, B, KV, G, D, k_ext,
                       static_cast<long long>(S_max) * KV * D, window, scale,
                       q_dtype, kv_dtype, chunk, stream);
}

const char* decode_attend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
