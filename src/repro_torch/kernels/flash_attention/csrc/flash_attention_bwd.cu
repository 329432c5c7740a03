// Causal GQA flash attention, backward: the gradient of flash_attention.cu /
// flash_attention_wgmma.cu's function, hand-written for Hopper (sm_90a) and
// bound to PyTorch through a plain C interface and ctypes (ops.py::
// flash_attention_bwd, wired into autograd by ops.py::FlashAttention).  This
// file holds the "mma_sync" (bf16) and "fma" (float32) routes of
// ops.py::bwd_route, and the delta pass every route runs first; bf16 with
// D in {64, 80, 128} takes the "wgmma" route (flash_attention_bwd_wgmma.cu),
// so the mma_sync route runs bf16 at D in {16, 32}, and at 64, 80 and 128
// only for a caller that names it.
//
// Replaces: nothing on the TPU.  The reference trains through XLA's autodiff
// of its pure-JAX attention (src/repro/models/attention.py:97,
// _chunked_attention); its Pallas kernel (src/repro/kernels/flash_attention/
// flash_attention.py:42) has no backward.  The port's forward is a kernel,
// so its gradient is one too.  Oracle: ref.py::flash_bwd_ref.
//
// What it computes.  For q, o, dO (B, S, H, D) and k, v (B, S, K, D), H = K*G,
// query head h = k*G + g, scale = 1/sqrt(D), the forward's causal (and
// optional sliding-window) mask and its LSE (B, H, S), natural log:
//
//   P   = exp(scale * q k^T - LSE)
//   dV  = P^T dO                          delta = rowsum(dO o o)
//   dS  = P o (dO V^T - delta)
//   dQ  = scale * dS K,   dK = scale * dS^T Q
//
// with every sum in f32, dq (B, S, H, D) and dk, dv (B, S, K, D) written once
// in the input dtype.
//
// Design: three kernels a call, no atomics and a fixed loop order, so the
// result is bitwise repeatable (ROADMAP's rule for every reduction):
//   * bwd_prep: delta per query row, eight lanes a row, to an f32 buffer
//     (the LSE comes from the forward kernel, which writes it beside o);
//   * bwd_dkdv: one block per (b, kv head, k tile): loops over the G query
//     heads of that kv head and over the q tiles that see the tile (causal,
//     inside the window), accumulates dK and dV in registers, writes once;
//   * bwd_dq: one block per (b, h, q tile): loops over the visible k tiles.
// bf16 runs every product on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), P and dS rounded to bf16 as the A operand, exponentials by
// the fast __expf (a few ulp of f32, far below bf16's rounding of P); float32
// runs them on the FMA units with expf, one row a thread.
//
// The bf16 kernels: four warps, 64-row tiles in shared memory row-major with
// rows padded by 8 bf16 (conflict-free ldmatrix); every fragment comes from
// ldmatrix, the transposed operands (dO and Q for dV and dK, K for dQ) from
// ldmatrix.trans on the same row-major tiles; the tile a block loops over
// (K and V in dq, the item's Q, dO, LSE and delta in dkdv) is double
// buffered with cp.async, so its next tile copies in during this one's
// products; blocks take their tile from blockIdx.y, so the longest causal
// bands start first.
//
// What bounds it on this card: the products, 2.5x the causal forward's
// 4 B H D S(S+1)/2 operations in the usual count; the mma_sync kernels run
// 3.5x (dkdv and dq both recompute P).  At the training shape
// (4, 4096, 16, 8, 128) bf16 that is 6.9e11 counted operations (0.70 ms at
// the 989 TFLOP/s bf16 peak) against 0.34 GB of tensors (0.10 ms at
// 3.35 TB/s): operations bound it.  mma.sync reaches a fraction of Hopper's
// tensor-core rate; the wgmma route is the redesign.
//
// Instantiated for D in {16, 32, 64, 80, 128} in bfloat16 and D in {16, 32,
// 64, 128} in float32.  At D = 80 (zamba2-2.7b's head dim) a tile row is 88
// bf16 (176 bytes: 16-byte cp.async rows and ldmatrix row addresses, the 8
// rows of an 8x8 matrix on distinct banks), the products take 5 k-chunks and
// 5 n-tile pairs (D / 8 = 10 accumulator n-tiles, an even count, which the
// paired ldmatrix loads need); f32 at D = 80 lies on no path (the forward's
// FMA kernel has no D = 80 tiling to write its LSE) and raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kNegInf;

constexpr int kThreads = 128;  // tensor-core kernels: 4 warps x 16 rows
constexpr int kTile = 64;      // query and key rows of a tile
constexpr int kFT = 32;        // FMA kernels: rows of a tile = threads

struct Strides {
  long long b, s, h;
};

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const float* lse;  // (B, H, S): the forward's, natural log
  float* delta;      // (B, H, S)
  int B, S, H, K, G;
  int window;  // <= 0: no window
  float scale;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  bool vec;  // every row 16-byte aligned (the bf16 kernels' cp.async needs it)
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ long long row_index(int b, int h, int H, int S, int s) {
  return (static_cast<long long>(b) * H + h) * S + s;
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (bf16)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory, one row address a lane.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 bytes global -> shared without the registers; zeros when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait for every committed copy group but the newest.
__device__ __forceinline__ void cp_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

// kTile rows (positions row0 .. row0 + kTile - 1, zeros past S) of one head
// of a (B, S, heads, D) tensor into shared memory, row-major with pitch P,
// by asynchronous 16-byte copies (every row is 16-byte aligned: the entry
// point refuses other inputs, and the wrapper copies them first).
template <int D, int P>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long stride_s,
                                           int row0, int S) {
  for (int i = threadIdx.x; i < kTile * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c8 = i % (D / 8);
    const bool live = row0 + r < S;
    cp_async16(dst + r * P + c8 * 8, src + (live ? row0 + r : 0) * stride_s + c8 * 8, live);
  }
}

// kTile per-row floats (LSE or delta of one (b, h)), zeros past S.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool live = row0 + r < S;
    cp_async4(dst + r, src + (live ? row0 + r : 0), live);
  }
}

// A fragment: rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a row-major tile.
template <int P>
__device__ __forceinline__ void lda(uint32_t a[4], const bf16* t, int r0, int c0, int lane) {
  ldsm4(a, t + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}

// B fragments of n-tiles n0 and n0 + 8 ({b0, b1} each) for k-chunk k0 ..
// k0 + 15, from a tile stored n-major ([n][k], as K for q k^T) ...
template <int P>
__device__ __forceinline__ void ldb_nk(uint32_t b[4], const bf16* t, int n0, int k0, int lane) {
  ldsm4(b, t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// ... and from a tile stored k-major ([k][n], as K for dS K), transposed
// on the way.
template <int P>
__device__ __forceinline__ void ldb_kn(uint32_t b[4], const bf16* t, int k0, int n0, int lane) {
  ldsm4_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + n0 + (lane >> 4) * 8);
}

// Accumulator n-tiles 2j and 2j + 1 of a 16-row product, rounded to bf16,
// as the A fragment of k-chunk j.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], float (*c)[4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

template <int D>
struct TcSmem {
  static constexpr int P = D + 8;  // bf16 pitch of a tile's rows (conflict-free ldmatrix)
  static constexpr size_t kRowTile = kTile * P * sizeof(bf16);
  static constexpr size_t kVec = kTile * sizeof(float);
  static constexpr size_t kDkdv = 6 * kRowTile + 4 * kVec;     // K, V, (Q, dO) x 2, (LSE, delta) x 2
  static constexpr size_t kDq = 6 * kRowTile;                   // Q, dO, (K, V) x 2
  static_assert(D % 16 == 0, "mma k-chunks of 16 and n-tile pairs of 16");
};

// ---------------------------------------------------------------------------
// bwd_dkdv_tc: dK and dV of one (b, kv head, k tile).  Warp w owns keys
// 16w + gq and 16w + gq + 8 of the tile; it computes the transposed products
// (keys as rows) S^T = K Q^T, dP^T = V dO^T, and accumulates
// dV += P^T dO and dK += dS^T Q, 32 queries at a time.  The (query head,
// q tile) items are double-buffered: the next item's Q, dO, LSE and delta
// copy in while this one computes.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_tc(const BwdArgs<bf16> a) {
  using C = TcSmem<D>;
  constexpr int P = C::P;
  constexpr int kQC = 32;  // queries per inner step (4 n-tiles)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * P;
  // Two buffers of the item's Q, dO, LSE and delta: buffer u at
  // Qb + u * kItem (bf16) and Vb + u * 2 * kTile (floats).
  bf16* Qb = Vs + kTile * P;
  constexpr int kItem = 2 * kTile * P;  // Q rows, then dO rows
  float* Fb = reinterpret_cast<float*>(Qb + 2 * kItem);  // LSE, then delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int kt = blockIdx.y;  // tile 0 sees the most q tiles: its blocks start first
  const int b = blockIdx.x / a.K, kh = blockIdx.x % a.K;
  const int kv0 = kt * kTile;
  const int kv_last = min(a.S, kv0 + kTile) - 1;
  const int qt_first = kv0 / kTile;
  const int q_end = a.window > 0 ? min(a.S - 1, kv_last + a.window - 1) : a.S - 1;
  const int nq = q_end / kTile - qt_first + 1;
  const int n_items = a.G * nq;  // item i: query head kh*G + i / nq, q tile qt_first + i % nq

  auto stage_item = [&](int i, int buf) {
    const int h = kh * a.G + i / nq, q0 = (qt_first + i % nq) * kTile;
    bf16* qd = Qb + buf * kItem;
    float* f = Fb + buf * 2 * kTile;
    stage_rows<D, P>(qd, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.S);
    stage_rows<D, P>(qd + kTile * P, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.S);
    stage_vec(f, a.lse + row_index(b, h, a.H, a.S, 0), q0, a.S);
    stage_vec(f + kTile, a.delta + row_index(b, h, a.H, a.S, 0), q0, a.S);
  };
  stage_rows<D, P>(Ks, a.k + b * a.ks.b + kh * a.ks.h, a.ks.s, kv0, a.S);
  stage_rows<D, P>(Vs, a.v + b * a.vs.b + kh * a.vs.h, a.vs.s, kv0, a.S);
  stage_item(0, 0);
  cp_commit();

  const int r0 = warp * 16;
  const int kpos0 = kv0 + r0 + gq, kpos1 = kpos0 + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) stage_item(i + 1, (i + 1) & 1);
    cp_commit();
    cp_wait_prior();
    __syncthreads();
    const bf16* Qs = Qb + (i & 1) * kItem;
    const bf16* Ds = Qs + kTile * P;  // dO
    const float* lse_s = Fb + (i & 1) * 2 * kTile;
    const float* del_s = lse_s + kTile;
    const int q0 = (qt_first + i % nq) * kTile;

#pragma unroll 1
    for (int qc = 0; qc < kTile / kQC; ++qc) {
      float p[kQC / 8][4], dp[kQC / 8][4];
#pragma unroll
      for (int nt = 0; nt < kQC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ka[4], va[4];
        lda<P>(ka, Ks, r0, kc * 16, lane);
        lda<P>(va, Vs, r0, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < kQC / 16; ++np) {
          uint32_t qb[4], db[4];
          ldb_nk<P>(qb, Qs, qc * kQC + np * 16, kc * 16, lane);
          ldb_nk<P>(db, Ds, qc * kQC + np * 16, kc * 16, lane);
          mma_16816(p[2 * np], ka, qb[0], qb[1]);
          mma_16816(p[2 * np + 1], ka, qb[2], qb[3]);
          mma_16816(dp[2 * np], va, db[0], db[1]);
          mma_16816(dp[2 * np + 1], va, db[2], db[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kQC / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qcol = qc * kQC + nt * 8 + 2 * tq + (e & 1);
          const int qpos = q0 + qcol;
          const bool on = qpos < a.S && visible(qpos, e < 2 ? kpos0 : kpos1, a.window);
          p[nt][e] = on ? __expf(p[nt][e] * a.scale - lse_s[qcol]) : 0.f;
          dp[nt][e] = p[nt][e] * (dp[nt][e] - del_s[qcol]);  // now dS^T
        }
      }
      // dV += P^T dO, dK += dS^T Q: k-chunks of 16 queries
#pragma unroll
      for (int j = 0; j < kQC / 16; ++j) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, p, j);
        acc_to_a(sa, dp, j);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t db[4], qb[4];
          ldb_kn<P>(db, Ds, qc * kQC + j * 16, np * 16, lane);
          ldb_kn<P>(qb, Qs, qc * kQC + j * 16, np * 16, lane);
          mma_16816(dv[2 * np], pa, db[0], db[1]);
          mma_16816(dv[2 * np + 1], pa, db[2], db[3]);
          mma_16816(dk[2 * np], sa, qb[0], qb[1]);
          mma_16816(dk[2 * np + 1], sa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // buffer i & 1 is free for item i + 2
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = half ? kpos1 : kpos0;
    if (kpos >= a.S) continue;
    bf16* kout = a.dk + b * a.dks.b + kpos * a.dks.s + kh * a.dks.h + 2 * tq;
    bf16* vout = a.dv + b * a.dvs.b + kpos * a.dvs.s + kh * a.dvs.h + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(kout + nd * 8) =
          pack_bf16(dk[nd][2 * half] * a.scale, dk[nd][2 * half + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(vout + nd * 8) =
          pack_bf16(dv[nd][2 * half], dv[nd][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_dq_tc: dQ of one (b, h, q tile).  Warp w owns query rows 16w + gq and
// 16w + gq + 8; per visible k tile (double-buffered), 32 keys at a time:
// S = Q K^T, dP = dO V^T, dS = P o (dP - delta), dQ += dS K.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_tc(const BwdArgs<bf16> a) {
  using C = TcSmem<D>;
  constexpr int P = C::P;
  constexpr int kKC = 32;  // keys per inner step (4 n-tiles)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + kTile * P;
  bf16* Kb = Qs + 2 * kTile * P;  // buffer u: K at Kb + 2u tiles, V one tile after

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal bands first
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kh = h / a.G;
  const int q0 = qt * kTile;
  const int q_last = min(a.S, q0 + kTile) - 1;
  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin = (kv_begin / kTile) * kTile;
  const int n_tiles = (q_last - kv_begin) / kTile + 1;
  const bf16* kbase = a.k + b * a.ks.b + kh * a.ks.h;
  const bf16* vbase = a.v + b * a.vs.b + kh * a.vs.h;

  stage_rows<D, P>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.S);
  stage_rows<D, P>(Ds, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.S);
  stage_rows<D, P>(Kb, kbase, a.ks.s, kv_begin, a.S);
  stage_rows<D, P>(Kb + kTile * P, vbase, a.vs.s, kv_begin, a.S);
  cp_commit();

  const int r0 = warp * 16;
  const int qpos0 = q0 + r0 + gq < a.S ? q0 + r0 + gq : -1;
  const int qpos1 = q0 + r0 + gq + 8 < a.S ? q0 + r0 + gq + 8 : -1;
  const float lse0 = qpos0 >= 0 ? a.lse[row_index(b, h, a.H, a.S, qpos0)] : 0.f;
  const float lse1 = qpos1 >= 0 ? a.lse[row_index(b, h, a.H, a.S, qpos1)] : 0.f;
  const float del0 = qpos0 >= 0 ? a.delta[row_index(b, h, a.H, a.S, qpos0)] : 0.f;
  const float del1 = qpos1 >= 0 ? a.delta[row_index(b, h, a.H, a.S, qpos1)] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = kv_begin + t * kTile;
    if (t + 1 < n_tiles) {
      bf16* next = Kb + ((t + 1) & 1) * 2 * kTile * P;
      stage_rows<D, P>(next, kbase, a.ks.s, kv0 + kTile, a.S);
      stage_rows<D, P>(next + kTile * P, vbase, a.vs.s, kv0 + kTile, a.S);
    }
    cp_commit();
    cp_wait_prior();
    __syncthreads();
    const bf16* Ks = Kb + (t & 1) * 2 * kTile * P;
    const bf16* Vs = Ks + kTile * P;

#pragma unroll 1
    for (int kc2 = 0; kc2 < kTile / kKC; ++kc2) {
      float p[kKC / 8][4], dp[kKC / 8][4];
#pragma unroll
      for (int nt = 0; nt < kKC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t qa[4], da[4];
        lda<P>(qa, Qs, r0, kc * 16, lane);
        lda<P>(da, Ds, r0, kc * 16, lane);
#pragma unroll
        for (int np = 0; np < kKC / 16; ++np) {
          uint32_t kb[4], vb[4];
          ldb_nk<P>(kb, Ks, kc2 * kKC + np * 16, kc * 16, lane);
          ldb_nk<P>(vb, Vs, kc2 * kKC + np * 16, kc * 16, lane);
          mma_16816(p[2 * np], qa, kb[0], kb[1]);
          mma_16816(p[2 * np + 1], qa, kb[2], kb[3]);
          mma_16816(dp[2 * np], da, vb[0], vb[1]);
          mma_16816(dp[2 * np + 1], da, vb[2], vb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kKC / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kv0 + kc2 * kKC + nt * 8 + 2 * tq + (e & 1);
          const bool on = visible(e < 2 ? qpos0 : qpos1, kpos, a.window);
          p[nt][e] = on ? __expf(p[nt][e] * a.scale - (e < 2 ? lse0 : lse1)) : 0.f;
          dp[nt][e] = p[nt][e] * (dp[nt][e] - (e < 2 ? del0 : del1));  // now dS
        }
      }
#pragma unroll
      for (int j = 0; j < kKC / 16; ++j) {
        uint32_t sa[4];
        acc_to_a(sa, dp, j);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t kb[4];
          ldb_kn<P>(kb, Ks, kc2 * kKC + j * 16, np * 16, lane);
          mma_16816(dq[2 * np], sa, kb[0], kb[1]);
          mma_16816(dq[2 * np + 1], sa, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // buffer t & 1 is free for tile t + 2
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = half ? qpos1 : qpos0;
    if (qpos < 0) continue;
    bf16* out = a.dq + b * a.dqs.b + qpos * a.dqs.s + h * a.dqs.h + 2 * tq;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8) =
          pack_bf16(dq[nd][2 * half] * a.scale, dq[nd][2 * half + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// FMA kernels (float32): one row a thread, kFT rows a block; the tiles and
// the thread's own accumulator row in shared memory (pitch D + 1, so a
// thread's own row and a broadcast row are both conflict-free).
// ---------------------------------------------------------------------------
template <int D>
struct FmaSmem {
  static constexpr int P = D + 1;
  static constexpr size_t kTileBytes = kFT * P * sizeof(float);
  static constexpr size_t kDkdv = 6 * kTileBytes + 2 * kFT * sizeof(float);
  static constexpr size_t kDq = 5 * kTileBytes;
};

// kFT rows of one head of a (B, S, heads, D) f32 tensor, zeros past S.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long stride_s,
                                              int row0, int S) {
  for (int i = threadIdx.x; i < kFT * D; i += kFT) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = row0 + r < S ? src[(row0 + r) * stride_s + d] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) s += x[d] * y[d];
  return s;
}

template <int D>
__global__ void __launch_bounds__(kFT) bwd_dkdv_fma(const BwdArgs<float> a) {
  constexpr int P = D + 1;
  extern __shared__ float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + kFT * P;
  float* Qs = Vs + kFT * P;
  float* Ds = Qs + kFT * P;
  float* dKs = Ds + kFT * P;
  float* dVs = dKs + kFT * P;
  float* lse_s = dVs + kFT * P;
  float* del_s = lse_s + kFT;
  const int j = threadIdx.x;
  const int b = blockIdx.y / a.K, kh = blockIdx.y % a.K;
  const int kv0 = blockIdx.x * kFT;
  const int kv_last = min(a.S, kv0 + kFT) - 1;
  const int kpos = kv0 + j;
  load_rows_f32<D>(Ks, a.k + b * a.ks.b + kh * a.ks.h, a.ks.s, kv0, a.S);
  load_rows_f32<D>(Vs, a.v + b * a.vs.b + kh * a.vs.h, a.vs.s, kv0, a.S);
  for (int d = 0; d < D; ++d) dKs[j * P + d] = dVs[j * P + d] = 0.f;
  const int q_end = a.window > 0 ? min(a.S - 1, kv_last + a.window - 1) : a.S - 1;
  for (int g = 0; g < a.G; ++g) {
    const int h = kh * a.G + g;
    for (int q0 = (kv0 / kFT) * kFT; q0 <= q_end; q0 += kFT) {
      __syncthreads();
      load_rows_f32<D>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.S);
      load_rows_f32<D>(Ds, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.S);
      const bool live = q0 + j < a.S;
      lse_s[j] = live ? a.lse[row_index(b, h, a.H, a.S, q0 + j)] : 0.f;
      del_s[j] = live ? a.delta[row_index(b, h, a.H, a.S, q0 + j)] : 0.f;
      __syncthreads();
      for (int i = 0; i < kFT; ++i) {
        const int qpos = q0 + i;
        if (qpos >= a.S || !visible(qpos, kpos, a.window)) continue;
        const float p = expf(dot_rows<D>(Ks + j * P, Qs + i * P) * a.scale - lse_s[i]);
        const float ds = p * (dot_rows<D>(Vs + j * P, Ds + i * P) - del_s[i]);
        for (int d = 0; d < D; ++d) {
          dVs[j * P + d] += p * Ds[i * P + d];
          dKs[j * P + d] += ds * Qs[i * P + d];
        }
      }
    }
  }
  if (kpos < a.S) {
    float* kout = a.dk + b * a.dks.b + kpos * a.dks.s + kh * a.dks.h;
    float* vout = a.dv + b * a.dvs.b + kpos * a.dvs.s + kh * a.dvs.h;
    for (int d = 0; d < D; ++d) {
      kout[d] = dKs[j * P + d] * a.scale;
      vout[d] = dVs[j * P + d];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFT) bwd_dq_fma(const BwdArgs<float> a) {
  constexpr int P = D + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;
  float* Ds = Qs + kFT * P;
  float* dQs = Ds + kFT * P;
  float* Ks = dQs + kFT * P;
  float* Vs = Ks + kFT * P;
  const int i = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H, kh = h / a.G;
  const int q0 = qt * kFT;
  const int q_last = min(a.S, q0 + kFT) - 1;
  const int qpos = q0 + i < a.S ? q0 + i : -1;
  load_rows_f32<D>(Qs, a.q + b * a.qs.b + h * a.qs.h, a.qs.s, q0, a.S);
  load_rows_f32<D>(Ds, a.dout + b * a.dos.b + h * a.dos.h, a.dos.s, q0, a.S);
  for (int d = 0; d < D; ++d) dQs[i * P + d] = 0.f;
  const float lse = qpos >= 0 ? a.lse[row_index(b, h, a.H, a.S, qpos)] : 0.f;
  const float del = qpos >= 0 ? a.delta[row_index(b, h, a.H, a.S, qpos)] : 0.f;
  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin = (kv_begin / kFT) * kFT;
  for (int kv0 = kv_begin; kv0 <= q_last; kv0 += kFT) {
    __syncthreads();
    load_rows_f32<D>(Ks, a.k + b * a.ks.b + kh * a.ks.h, a.ks.s, kv0, a.S);
    load_rows_f32<D>(Vs, a.v + b * a.vs.b + kh * a.vs.h, a.vs.s, kv0, a.S);
    __syncthreads();
    for (int c = 0; c < kFT; ++c) {
      if (!visible(qpos, kv0 + c, a.window)) continue;
      const float p = expf(dot_rows<D>(Qs + i * P, Ks + c * P) * a.scale - lse);
      const float ds = p * (dot_rows<D>(Ds + i * P, Vs + c * P) - del);
      for (int d = 0; d < D; ++d) dQs[i * P + d] += ds * Ks[c * P + d];
    }
  }
  if (qpos >= 0) {
    float* out = a.dq + b * a.dqs.b + qpos * a.dqs.s + h * a.dqs.h;
    for (int d = 0; d < D; ++d) out[d] = dQs[i * P + d] * a.scale;
  }
}

// ---------------------------------------------------------------------------
// bwd_prep: delta = rowsum(dO o o) in f32 for every row (b, h, s), eight
// lanes a row in a fixed order, at (b H + h) pitch + s.  With lse2 (the
// wgmma route) it also writes the forward's LSE in log2 units there, and
// pads rows S .. pitch - 1 (delta 0, lse2 +inf: P = exp2(-inf) = 0).
// ---------------------------------------------------------------------------
template <typename T>
struct PrepArgs {
  const T* o;
  const T* dout;
  const float* lse;  // (B, H, S) natural log; read only with lse2
  float* delta;      // (B, H, pitch)
  float* lse2;       // (B, H, pitch) log2 units, or null
  int S, H, pitch;
  Strides os, dos;
  bool vec;  // o and dO rows 16-byte aligned: 16-byte loads
};

constexpr int kPrepThreads = 256;
constexpr int kPrepRows = kPrepThreads / 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kPrepThreads) bwd_prep(const PrepArgs<T> a) {
  constexpr int kV = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int lane8 = threadIdx.x & 7;
  const int s = blockIdx.x * kPrepRows + threadIdx.x / 8;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  float acc = 0.f;
  if (s < a.S) {
    const T* op = a.o + b * a.os.b + s * a.os.s + h * a.os.h;
    const T* dp = a.dout + b * a.dos.b + s * a.dos.s + h * a.dos.h;
    if (a.vec) {
      for (int c = lane8; c < D / kV; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c * kV);
        const uint4 dv = *reinterpret_cast<const uint4*>(dp + c * kV);
        const T* oe = reinterpret_cast<const T*>(&ov);
        const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int j = 0; j < kV; ++j) acc += to_f32(oe[j]) * to_f32(de[j]);
      }
    } else {
      for (int d = lane8; d < D; d += 8) acc += to_f32(op[d]) * to_f32(dp[d]);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (lane8 == 0 && s < a.pitch) {
    const long long row = static_cast<long long>(bh) * a.pitch + s;
    a.delta[row] = acc;
    if (a.lse2 != nullptr)
      a.lse2[row] = s < a.S ? a.lse[static_cast<long long>(bh) * a.S + s] * 1.4426950408889634f
                            : __int_as_float(0x7f800000);
  }
}

template <typename T>
int launch_prep(const PrepArgs<T>& p, int B, int D, cudaStream_t st) {
  const dim3 grid((p.pitch + kPrepRows - 1) / kPrepRows, B * p.H);
  switch (D) {
    case 16: bwd_prep<T, 16><<<grid, kPrepThreads, 0, st>>>(p); break;
    case 32: bwd_prep<T, 32><<<grid, kPrepThreads, 0, st>>>(p); break;
    case 64: bwd_prep<T, 64><<<grid, kPrepThreads, 0, st>>>(p); break;
    case 80: bwd_prep<T, 80><<<grid, kPrepThreads, 0, st>>>(p); break;
    case 128: bwd_prep<T, 128><<<grid, kPrepThreads, 0, st>>>(p); break;
    default: return flash::kErrRoute;
  }
  return static_cast<int>(cudaGetLastError());
}

// The delta pass of this file's kernels: pitch S, no log2 LSE.
template <typename T>
int launch_delta(const BwdArgs<T>& a, int D, cudaStream_t st) {
  PrepArgs<T> p;
  p.o = a.o;
  p.dout = a.dout;
  p.lse = a.lse;
  p.delta = a.delta;
  p.lse2 = nullptr;
  p.S = a.S;
  p.H = a.H;
  p.pitch = a.S;
  p.os = a.os;
  p.dos = a.dos;
  p.vec = a.vec;
  return launch_prep(p, a.B, D, st);
}

// ---------------------------------------------------------------------------
// Launch: prep, dkdv, dq on the caller's stream, each checked.
// ---------------------------------------------------------------------------
// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int D>
int launch_tc(const BwdArgs<bf16>& a, cudaStream_t st) {
  using C = TcSmem<D>;
  // tiles on y, (b, head) on x: blocks start in linear order, so the
  // longest causal bands (y = 0) start first
  const dim3 grid_q(a.B * a.H, (a.S + kTile - 1) / kTile);
  const dim3 grid_k(a.B * a.K, (a.S + kTile - 1) / kTile);
  int err;
  if ((err = launch_delta(a, D, st))) return err;
  if ((err = allow_smem(bwd_dkdv_tc<D>, C::kDkdv))) return err;
  bwd_dkdv_tc<D><<<grid_k, kThreads, C::kDkdv, st>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(bwd_dq_tc<D>, C::kDq))) return err;
  bwd_dq_tc<D><<<grid_q, kThreads, C::kDq, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fma(const BwdArgs<float>& a, cudaStream_t st) {
  using C = FmaSmem<D>;
  const dim3 grid_q((a.S + kFT - 1) / kFT, a.B * a.H);
  const dim3 grid_k((a.S + kFT - 1) / kFT, a.B * a.K);
  int err;
  if ((err = launch_delta(a, D, st))) return err;
  if ((err = allow_smem(bwd_dkdv_fma<D>, C::kDkdv))) return err;
  bwd_dkdv_fma<D><<<grid_k, kFT, C::kDkdv, st>>>(a);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(bwd_dq_fma<D>, C::kDq))) return err;
  bwd_dq_fma<D><<<grid_q, kFT, C::kDq, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
BwdArgs<T> make_args(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, void* dq, void* dk, void* dv, const void* lse,
                     void* delta,
                     int B, int S, int H, int K, int D, int window, const long long* st) {
  BwdArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<const T*>(o);
  a.dout = static_cast<const T*>(dout);
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.B = B;
  a.S = S;
  a.H = H;
  a.K = K;
  a.G = H / K;
  a.window = window;
  // 1/sqrt(D) rounded once from double, as the forward kernels
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  Strides* all[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  long long mask = 0;
  for (int i = 0; i < 8; ++i) {
    *all[i] = {st[3 * i], st[3 * i + 1], st[3 * i + 2]};
    mask |= st[3 * i] | st[3 * i + 1] | st[3 * i + 2];
  }
  const void* ptrs[5] = {q, k, v, o, dout};
  bool aligned = mask % 8 == 0;
  for (const void* p : ptrs) aligned = aligned && reinterpret_cast<unsigned long long>(p) % 16 == 0;
  a.vec = aligned;
  return a;
}

bool valid(int B, int H, int K) { return K > 0 && H % K == 0 && B * H <= 65535; }

}  // namespace

int flash::bwd_prep_bf16(const void* o, const void* dout, const float* lse, float* delta,
                         float* lse2, int B, int S, int H, int D, long long osb, long long oss,
                         long long osh, long long dosb, long long doss, long long dosh,
                         void* stream) {
  PrepArgs<bf16> p;
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.lse2 = lse2;
  p.S = S;
  p.H = H;
  p.pitch = bwd_pitch(S);
  p.os = {osb, oss, osh};
  p.dos = {dosb, doss, dosh};
  p.vec = (osb | oss | osh | dosb | doss | dosh) % 8 == 0 &&
          reinterpret_cast<unsigned long long>(o) % 16 == 0 &&
          reinterpret_cast<unsigned long long>(dout) % 16 == 0;
  return launch_prep(p, B, D, static_cast<cudaStream_t>(stream));
}

extern "C" {

#define BWD_STRIDES                                                                  \
  const long long st[24] = {qsb,  qss,  qsh,  ksb,  kss,  ksh,  vsb,  vss,           \
                            vsh,  osb,  oss,  osh,  dosb, doss, dosh, dqsb,          \
                            dqss, dqsh, dksb, dkss, dksh, dvsb, dvss, dvsh}

// The backward entry points share one signature: lse is the forward's
// (B, H, S) natural-log LSE (read), delta scratch of
// flash_attention_bwd_scratch_floats(B, H, S) floats (written).
//
// One call runs bwd_prep, bwd_dkdv and bwd_dq (mma.sync kernels).
int flash_attention_bwd_bf16(BWD_ARGS) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (!valid(B, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  BWD_STRIDES;
  const auto a = make_args<bf16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, K, D,
                                 window, st);
  if (!a.vec) return flash::kErrRoute;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_tc<16>(a, s);
    case 32: return launch_tc<32>(a, s);
    case 64: return launch_tc<64>(a, s);
    case 80: return launch_tc<80>(a, s);
    case 128: return launch_tc<128>(a, s);
    default: return flash::kErrRoute;
  }
}

// One call runs bwd_prep, bwd_dkdv and bwd_dq (FMA kernels).
int flash_attention_bwd_f32(BWD_ARGS) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (!valid(B, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  BWD_STRIDES;
  const auto a = make_args<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, S, H, K, D,
                                  window, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fma<16>(a, s);
    case 32: return launch_fma<32>(a, s);
    case 64: return launch_fma<64>(a, s);
    case 128: return launch_fma<128>(a, s);
    default: return flash::kErrRoute;
  }
}

// The delta (and the wgmma route's log2 LSE) scratch a backward call takes:
// two f32 (B, H, S rounded up to 128) buffers.
long long flash_attention_bwd_scratch_floats(int B, int H, int S) {
  return 2LL * B * H * flash::bwd_pitch(S);
}

}  // extern "C"
