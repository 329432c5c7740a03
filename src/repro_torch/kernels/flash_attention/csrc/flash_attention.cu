// Causal GQA flash attention (forward), hand-written for Hopper (sm_90a),
// bound to PyTorch through a plain C interface and ctypes: the "mma_sync"
// and "fma" routes of ops.py::route.  bf16 with D in {64, 80, 128} and
// 16-byte aligned pointers and strides takes the "wgmma" route instead
// (flash_attention_wgmma.cu); this file keeps the inputs that route does
// not take: bf16 at D in {16, 32}, or at 64, 80 or 128 with unaligned rows
// (mma_sync), and float32 or bf16 at D = 8 (fma).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_kernel
// (launched by flash_attention_pallas, wrapped by ops.py::flash_attention;
// oracle ref.py::flash_ref).  It computes what that kernel computes,
//
//   o[b, s, k*G + g, :] = softmax_{t <= s, s - t < window}(q . k_t / sqrt(D)) . V
//
// for q (B, S, H, D) and k/v (B, S, K, D) with H = K * G, softmax in f32,
// output in q's dtype.  Numerics follow the TPU kernel: an online softmax
// carries the running max m, sum l and accumulator acc in f32 across KV
// tiles; masked scores are NEG_INF = -1e30 and their probabilities are 0
// (mask-aware exp, never exp(NEG_INF - NEG_INF)); p is rounded to v's
// dtype before the PV product, which accumulates in f32; the final divide
// floors l at 1e-30.  Given an LSE pointer, each kernel also writes every
// real row's log-sum-exp of the scaled scores, m + log l (natural log, f32,
// (B, H, S)): the backward's input (ref.py::flash_lse).
//
// What it does not carry over: the TPU wrapper's transpose of q into
// (B*K, nq, G*Bq, D) tiles and its S % block == 0 tiling exist for the
// TPU's 128-wide lanes.  Here the kernel reads q, k and v in place through
// their strides (the last dimension contiguous), takes any S >= 1 and masks
// the ragged last q and KV tiles itself.  The TPU's sequential KV grid axis
// becomes a loop inside the block.
//
// What bounds it on this card: the two products, 4 B H D S(S+1)/2
// operations with the causal band, against reading q, k, v and writing o
// once.  At the main-path shape (B, S, H, K, D) = (8, 2048, 16, 8, 128) in
// bf16 that is 1.375e11 operations (0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak) against 201 MB (0.060 ms at 3.35 TB/s): operations
// bound it.  What the design does about the operation count:
//   * bf16 (D >= 16) runs both products on the tensor cores
//     (mma.sync.m16n8k16, f32 accumulation), with the online softmax on
//     the accumulator fragments in registers; f32, and bf16 at D = 8,
//     run them on the f32 FMA units (flash_fwd_kernel);
//   * one block per (b, kv head, q tile, group of query heads): its rows
//     are the G grouped query heads of the tile, as in the TPU kernel, so
//     each K/V tile staged in shared memory serves all G heads;
//   * only the KV tiles that meet the causal band (and the window band,
//     where there is one) are visited, so the work is the causal half of
//     S^2 and not all of it; the q tiles run last-first, so the longest
//     bands start first;
//   * no thread holds a whole accumulator row: at D = 128 a row is split
//     over 16 threads of 8 values (FMA path) or over a quad of lanes in
//     mma fragments (tensor-core path); shared memory rows are padded
//     against bank conflicts.
// Instantiated for D in {8, 16, 32, 64, 128} in float32 and bfloat16 (FMA
// kernel), and for D in {16, 32, 64, 80, 128} in bfloat16 (tensor-core
// kernel).  D = 80 is zamba2-2.7b's head dim (2560 / 32), which the main
// path runs on the wgmma route; here it serves unaligned rows and callers
// that name the route: 5 k-chunks of Q K^T and 10 n-tiles of O; its rows of 88 bf16 (176 bytes) keep the
// 16-byte stores and make the fragment loads of 8 rows x 4 lanes hit 32
// distinct banks (row r starts at bank 12 r mod 32).  The FMA kernel's
// accumulator tiling (kTD = D / 8 threads a row dividing 256) has no
// D = 80 instantiation; f32 at D = 80 lies on no path and raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"

namespace {

using flash::kMinL;
using flash::kNegInf;

constexpr int kThreads = 256;
constexpr int kRows = 64;  // (query head, query position) rows per block

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  // x rounded to this dtype, back in f32
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// Element strides of dims (b, s, h); the last dimension is contiguous.
struct Strides {
  long long b, s, h;
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* lse;  // (B, H, S) natural-log LSE per row, or null: none
  int S, K, G;
  int group;   // query heads per block (GC <= kRows)
  int bq;      // query positions per block: kRows / group
  int window;  // <= 0: no window
  float scale;
  Strides qs, ks, vs, os;
  bool vec;  // q, k, v rows 16-byte aligned: 16-byte loads (tensor-core path)
};

template <int D, int BK>
struct Tile {
  static constexpr int kQPitch = D + 1;  // padded: conflict-free column reads
  static constexpr int kKPitch = D + 1;
  static constexpr int kPPitch = BK + 1;
  // Scores: 16 x 16 threads, each kSR rows x kSC columns of (kRows x BK).
  static constexpr int kSR = kRows / 16;
  static constexpr int kSC = BK / 16;
  // Accumulator: kTR x kTD threads, each kRM rows x kDM columns of
  // (kRows x D); columns interleaved (td + kTD * j).
  static constexpr int kDM = D / 4 < 8 ? D / 4 : 8;
  static constexpr int kTD = D / kDM;
  static constexpr int kTR = kThreads / kTD;
  static constexpr int kRM = kRows / kTR;
  static constexpr int kSmemFloats =
      kRows * kQPitch + BK * kKPitch + BK * D + kRows * kPPitch + 3 * kRows;
  static constexpr size_t kSmemBytes = (kSmemFloats + kRows) * 4;  // + row_q
  static_assert(kTR * kRM == kRows, "accumulator tiling");
  static_assert(kSC * 16 == BK && BK % 4 == 0, "score tiling");
  static_assert(kThreads == 4 * kRows, "four softmax threads per row");
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Args<T> a) {
  using C = Tile<D, BK>;
  extern __shared__ float smem[];
  float* Qs = smem;                         // kRows x kQPitch
  float* Ks = Qs + kRows * C::kQPitch;      // BK x kKPitch
  float* Vs = Ks + BK * C::kKPitch;         // BK x D
  float* Ps = Vs + BK * D;                  // kRows x kPPitch
  float* m_s = Ps + kRows * C::kPPitch;     // running max
  float* l_s = m_s + kRows;                 // running sum
  float* a_s = l_s + kRows;                 // this tile's rescale factor
  int* row_q = reinterpret_cast<int*>(a_s + kRows);  // query position or -1

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal bands first
  const int b = blockIdx.y / a.K;
  const int kh = blockIdx.y % a.K;
  const int g0 = blockIdx.z * a.group;
  const int q0 = qt * a.bq;
  const int q_last = min(a.S, q0 + a.bq) - 1;

  // Row r holds query head kh*G + g0 + r / bq at position q0 + r % bq.
  for (int r = tid; r < kRows; r += kThreads) {
    const int g = g0 + r / a.bq;
    const int s = q0 + r % a.bq;
    const bool live = r < a.group * a.bq && g < a.G && s < a.S;
    row_q[r] = live ? s : -1;
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (row_q[r] >= 0) {
      const int h = kh * a.G + g0 + r / a.bq;
      x = Num<T>::load(a.q[b * a.qs.b + row_q[r] * a.qs.s + h * a.qs.h + d]);
    }
    Qs[r * C::kQPitch + d] = x;
  }

  const int sy = tid / 16, sx = tid % 16;           // score tile
  const int tr = tid / C::kTD, td = tid % C::kTD;   // accumulator tile
  float acc[C::kRM][C::kDM];
#pragma unroll
  for (int i = 0; i < C::kRM; ++i)
#pragma unroll
    for (int j = 0; j < C::kDM; ++j) acc[i][j] = 0.f;

  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  for (int kv0 = kv_begin; kv0 <= q_last; kv0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int t = kv0 + c;
      float kx = 0.f, vx = 0.f;
      if (t < a.S) {  // ragged last tile: zeros, and masked below
        kx = Num<T>::load(a.k[b * a.ks.b + t * a.ks.s + kh * a.ks.h + d]);
        vx = Num<T>::load(a.v[b * a.vs.b + t * a.vs.s + kh * a.vs.h + d]);
      }
      Ks[c * C::kKPitch + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    // S = Q K^T * scale, masked to NEG_INF.
    {
      float s[C::kSR][C::kSC];
#pragma unroll
      for (int i = 0; i < C::kSR; ++i)
#pragma unroll
        for (int j = 0; j < C::kSC; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[C::kSR], kv[C::kSC];
#pragma unroll
        for (int i = 0; i < C::kSR; ++i) qv[i] = Qs[(sy + 16 * i) * C::kQPitch + d];
#pragma unroll
        for (int j = 0; j < C::kSC; ++j) kv[j] = Ks[(sx + 16 * j) * C::kKPitch + d];
#pragma unroll
        for (int i = 0; i < C::kSR; ++i)
#pragma unroll
          for (int j = 0; j < C::kSC; ++j) s[i][j] += qv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < C::kSR; ++i) {
        const int r = sy + 16 * i;
        const int qpos = row_q[r];
#pragma unroll
        for (int j = 0; j < C::kSC; ++j) {
          const int c = sx + 16 * j;
          Ps[r * C::kPPitch + c] =
              visible(qpos, kv0 + c, a.window) ? s[i][j] * a.scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // Online softmax: four threads per row, columns interleaved.
    {
      const int r = tid >> 2, part = tid & 3;
      const int qpos = row_q[r];
      float* prow = Ps + r * C::kPPitch;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) mx = fmaxf(mx, prow[part + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int c = part + 4 * j;
        const float p =
            visible(qpos, kv0 + c, a.window) ? expf(prow[c] - m_new) : 0.f;
        sum += p;
        prow[c] = Num<T>::round(p);  // p in v's dtype for the PV product
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
      const int r = tr + C::kTR * i;
      const float alpha = a_s[r];
#pragma unroll
      for (int j = 0; j < C::kDM; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[C::kDM];
#pragma unroll
      for (int j = 0; j < C::kDM; ++j) vv[j] = Vs[c * D + td + C::kTD * j];
#pragma unroll
      for (int i = 0; i < C::kRM; ++i) {
        const float p = Ps[(tr + C::kTR * i) * C::kPPitch + c];
#pragma unroll
        for (int j = 0; j < C::kDM; ++j) acc[i][j] += p * vv[j];
      }
    }
  }

  // o = acc / max(l, 1e-30); l_s is final since the last softmax's sync.
#pragma unroll
  for (int i = 0; i < C::kRM; ++i) {
    const int r = tr + C::kTR * i;
    const int qpos = row_q[r];
    if (qpos < 0) continue;
    const int h = kh * a.G + g0 + r / a.bq;
    const float l = fmaxf(l_s[r], kMinL);
    if (a.lse != nullptr && td == 0)
      a.lse[(static_cast<long long>(b) * a.K * a.G + h) * a.S + qpos] = m_s[r] + logf(l);
    T* out = a.o + b * a.os.b + qpos * a.os.s + h * a.os.h;
#pragma unroll
    for (int j = 0; j < C::kDM; ++j) out[td + C::kTD * j] = Num<T>::store(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  constexpr int BK = D >= 128 ? 32 : 64;  // keeps a block under 80 KB
  using C = Tile<D, BK>;
  auto kernel = flash_fwd_kernel<T, D, BK>;
  if (C::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_q_tiles = (a.S + a.bq - 1) / a.bq;
  const int n_groups = (a.G + a.group - 1) / a.group;
  const dim3 grid(n_q_tiles, B * a.K, n_groups);
  kernel<<<grid, kThreads, C::kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core path: bfloat16 with D in {16, 32, 64, 80, 128}.
//
// The same block and row mapping as the FMA kernel (kRows rows of (query
// head, position), the KV band walked tile by tile), with both products on
// the tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate):
// four warps, each owning 16 of the block's rows.  Per warp and KV tile:
//   S (16 x BK)  = Q (16 x D) K^T,   Q's fragments held in registers;
//   online softmax on S's accumulator fragments, in registers: a row's
//     eight columns of an n-tile sit in the four lanes of a quad, so its
//     max and sum take two shuffles;
//   O (16 x D)  += P (16 x BK) V,    P rounded to bf16 and re-used as the
//     A fragment straight from S's accumulator layout.
// K sits in shared memory row-major (key x d), V transposed (d x key), so
// every B fragment is two 32-bit shared loads; rows are padded by 8 bf16
// so that the 32 lanes of a fragment load hit 32 banks.
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;  // 4 warps x 16 rows = kRows

template <int D, int BK>
struct TcTile {
  static constexpr int kQP = D + 8;   // bf16 pitch of the Q and K rows
  static constexpr int kVP = BK + 8;  // bf16 pitch of the transposed V rows
  static constexpr int kKC = D / 16;  // k-chunks of Q K^T
  static constexpr int kNS = BK / 8;  // n-tiles of S
  static constexpr int kNO = D / 8;   // n-tiles of O
  static constexpr size_t kSmemBytes =
      (kRows * kQP + BK * kQP + D * kVP) * sizeof(__nv_bfloat16) + kRows * sizeof(int);
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma tiling");
  static_assert(kTcThreads / 32 * 16 == kRows, "16 rows per warp");
};

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Eight consecutive bf16 from device memory: one 16-byte load when the
// wrapper found every row 16-byte aligned, else eight 2-byte loads.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 r;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = p[j];
  return r;
}

template <int D, int BK>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const Args<__nv_bfloat16> a) {
  using C = TcTile<D, BK>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // kRows x kQP
  __nv_bfloat16* Ks = Qs + kRows * C::kQP;                         // BK x kQP
  __nv_bfloat16* Vt = Ks + BK * C::kQP;                            // D x kVP
  int* row_q = reinterpret_cast<int*>(Vt + D * C::kVP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row / column pair
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / a.K;
  const int kh = blockIdx.y % a.K;
  const int g0 = blockIdx.z * a.group;
  const int q0 = qt * a.bq;
  const int q_last = min(a.S, q0 + a.bq) - 1;
  const bool vec = a.vec;

  for (int r = tid; r < kRows; r += kTcThreads) {
    const int g = g0 + r / a.bq;
    const int s = q0 + r % a.bq;
    row_q[r] = (r < a.group * a.bq && g < a.G && s < a.S) ? s : -1;
  }
  __syncthreads();
  for (int i = tid; i < kRows * (D / 8); i += kTcThreads) {
    const int r = i / (D / 8), c8 = i % (D / 8);
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row_q[r] >= 0) {
      const int h = kh * a.G + g0 + r / a.bq;
      x = load8(a.q + b * a.qs.b + row_q[r] * a.qs.s + h * a.qs.h + c8 * 8, vec);
    }
    *reinterpret_cast<uint4*>(Qs + r * C::kQP + c8 * 8) = x;
  }
  __syncthreads();

  // This warp's rows r0 (fragment rows gq) and r0 + 8.
  const int r0 = warp * 16 + gq;
  const int qpos0 = row_q[r0], qpos1 = row_q[r0 + 8];
  uint32_t qf[C::kKC][4];
#pragma unroll
  for (int kc = 0; kc < C::kKC; ++kc) {
    const __nv_bfloat16* p0 = Qs + r0 * C::kQP + kc * 16 + 2 * tq;
    const __nv_bfloat16* p1 = p0 + 8 * C::kQP;
    qf[kc][0] = lds32(p0);
    qf[kc][1] = lds32(p1);
    qf[kc][2] = lds32(p0 + 8);
    qf[kc][3] = lds32(p1 + 8);
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[C::kNO][4];
#pragma unroll
  for (int nt = 0; nt < C::kNO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  int kv_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  for (int kv0 = kv_begin; kv0 <= q_last; kv0 += BK) {
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = tid; i < BK * (D / 8); i += kTcThreads) {
      const int c = i / (D / 8), c8 = i % (D / 8);  // K: 16-byte chunks along d
      const int t = kv0 + c;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (t < a.S) x = load8(a.k + b * a.ks.b + t * a.ks.s + kh * a.ks.h + c8 * 8, vec);
      *reinterpret_cast<uint4*>(Ks + c * C::kQP + c8 * 8) = x;
    }
    for (int i = tid; i < BK * (D / 8); i += kTcThreads) {
      const int c = i % BK, c8 = i / BK;  // V: keys fastest, for the transpose
      const int t = kv0 + c;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (t < a.S) x = load8(a.v + b * a.vs.b + t * a.vs.s + kh * a.vs.h + c8 * 8, vec);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c8 * 8 + j) * C::kVP + c] = e[j];
    }
    __syncthreads();

    // S = Q K^T, scaled and masked
    float s[C::kNS][4];
#pragma unroll
    for (int nt = 0; nt < C::kNS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = Ks + (nt * 8 + gq) * C::kQP + 2 * tq;
#pragma unroll
      for (int kc = 0; kc < C::kKC; ++kc)
        mma_16816(s[nt], qf[kc], lds32(kp + kc * 16), lds32(kp + kc * 16 + 8));
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < C::kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + nt * 8 + 2 * tq + (e & 1);
        const bool on = visible(e < 2 ? qpos0 : qpos1, kpos, a.window);
        s[nt][e] = on ? s[nt][e] * a.scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < C::kNS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kv0 + nt * 8 + 2 * tq + (e & 1);
        const bool on = visible(e < 2 ? qpos0 : qpos1, kpos, a.window);
        s[nt][e] = on ? expf(s[nt][e] - (e < 2 ? mn0 : mn1)) : 0.f;  // now p
      }
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < C::kNO; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }

    // O += P V: S's accumulator n-tiles 2j and 2j+1 are P's A fragment
    // for keys 16j .. 16j+15, rounded to bf16.
#pragma unroll
    for (int j = 0; j < C::kNS / 2; ++j) {
      const uint32_t pf[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int nt = 0; nt < C::kNO; ++nt) {
        const __nv_bfloat16* vp = Vt + (nt * 8 + gq) * C::kVP + j * 16 + 2 * tq;
        mma_16816(o[nt], pf, lds32(vp), lds32(vp + 8));
      }
    }
  }

  // o = acc / max(l, 1e-30), two bf16 per store
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const int qpos = half ? qpos1 : qpos0;
    if (qpos < 0) continue;
    const int h = kh * a.G + g0 + r / a.bq;
    const float l = fmaxf(half ? l1 : l0, kMinL);
    if (a.lse != nullptr && tq == 0)
      a.lse[(static_cast<long long>(b) * a.K * a.G + h) * a.S + qpos] = (half ? m1 : m0) + logf(l);
    __nv_bfloat16* out = a.o + b * a.os.b + qpos * a.os.s + h * a.os.h + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < C::kNO; ++nt) {
      const float x0 = o[nt][2 * half] / l, x1 = o[nt][2 * half + 1] / l;
      *reinterpret_cast<uint32_t*>(out + nt * 8) = pack_bf16(x0, x1);
    }
  }
}

template <int D>
int launch_tc(const Args<__nv_bfloat16>& a, int B, cudaStream_t stream) {
  constexpr int BK = 64;
  using C = TcTile<D, BK>;
  auto kernel = flash_fwd_tc_kernel<D, BK>;
  if (C::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.S + a.bq - 1) / a.bq, B * a.K, (a.G + a.group - 1) / a.group);
  kernel<<<grid, kTcThreads, C::kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v, void* o, void* lse, int S, int H,
                  int K, int D, int window, long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                  long long vsh, long long osb, long long oss, long long osh) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<T*>(o);
  a.lse = static_cast<float*>(lse);
  a.S = S;
  a.K = K;
  a.G = H / K;
  a.group = a.G < kRows ? a.G : kRows;
  a.bq = kRows / a.group;
  a.window = window;
  // 1/sqrt(D) rounded once from double, as the reference's Python scale
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  a.qs = {qsb, qss, qsh};
  a.ks = {ksb, kss, ksh};
  a.vs = {vsb, vss, vsh};
  a.os = {osb, oss, osh};
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  a.vec = aligned(q) && aligned(k) && aligned(v) &&
          (qsb | qss | qsh | ksb | kss | ksh | vsb | vss | vsh) % 8 == 0;
  return a;
}

// The FMA kernel, any D of the instantiations.
template <typename T>
int run_fma(const Args<T>& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(a, B, st);
    case 16: return launch<T, 16>(a, B, st);
    case 32: return launch<T, 32>(a, B, st);
    case 64: return launch<T, 64>(a, B, st);
    case 128: return launch<T, 128>(a, B, st);
    default: return flash::kErrRoute;
  }
}

// The mma.sync kernel, bf16 with D >= 16 (one k-chunk of m16n8k16).
int run_mma_sync(const Args<__nv_bfloat16>& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_tc<16>(a, B, st);
    case 32: return launch_tc<32>(a, B, st);
    case 64: return launch_tc<64>(a, B, st);
    case 80: return launch_tc<80>(a, B, st);
    case 128: return launch_tc<128>(a, B, st);
    default: return flash::kErrRoute;
  }
}

bool valid(int B, int H, int K) { return K > 0 && H % K == 0 && B * K <= 65535; }

}  // namespace

extern "C" {

#define FLASH_ARGS                                                           \
  const void *q, const void *k, const void *v, void *o, int B, int S, int H, \
      int K, int D, int window, long long qsb, long long qss, long long qsh, \
      long long ksb, long long kss, long long ksh, long long vsb,            \
      long long vss, long long vsh, long long osb, long long oss,            \
      long long osh, void *stream
#define FLASH_ARGS_LSE                                                       \
  const void *q, const void *k, const void *v, void *o, int B, int S, int H, \
      int K, int D, int window, long long qsb, long long qss, long long qsh, \
      long long ksb, long long kss, long long ksh, long long vsb,            \
      long long vss, long long vsh, long long osb, long long oss,            \
      long long osh, void *lse, void *stream
#define FLASH_STRIDES \
  qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh

// Entry points with an LSE output (FLASH_ARGS, then `lse`: a contiguous
// f32 (B, H, S) buffer, or null), and the ones without it.
int flash_attention_fma_lse_f32(FLASH_ARGS_LSE) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (!valid(B, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto a = make_args<float>(q, k, v, o, lse, S, H, K, D, window, FLASH_STRIDES);
  return run_fma(a, B, D, static_cast<cudaStream_t>(stream));
}

int flash_attention_fma_lse_bf16(FLASH_ARGS_LSE) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (!valid(B, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto a = make_args<__nv_bfloat16>(q, k, v, o, lse, S, H, K, D, window, FLASH_STRIDES);
  return run_fma(a, B, D, static_cast<cudaStream_t>(stream));
}

int flash_attention_mma_sync_lse_bf16(FLASH_ARGS_LSE) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (!valid(B, H, K)) return static_cast<int>(cudaErrorInvalidValue);
  const auto a = make_args<__nv_bfloat16>(q, k, v, o, lse, S, H, K, D, window, FLASH_STRIDES);
  return run_mma_sync(a, B, D, static_cast<cudaStream_t>(stream));
}

int flash_attention_fma_f32(FLASH_ARGS) {
  return flash_attention_fma_lse_f32(q, k, v, o, B, S, H, K, D, window, FLASH_STRIDES, nullptr,
                                     stream);
}

int flash_attention_fma_bf16(FLASH_ARGS) {
  return flash_attention_fma_lse_bf16(q, k, v, o, B, S, H, K, D, window, FLASH_STRIDES, nullptr,
                                      stream);
}

int flash_attention_mma_sync_bf16(FLASH_ARGS) {
  return flash_attention_mma_sync_lse_bf16(q, k, v, o, B, S, H, K, D, window, FLASH_STRIDES,
                                           nullptr, stream);
}

const char* flash_error_string(int err) {
  switch (err) {
    case flash::kErrRoute: return "arguments outside this entry point's route";
    case flash::kErrNoEncoder: return "the CUDA driver has no cuTensorMapEncodeTiled";
    case flash::kErrTensorMap: return "cuTensorMapEncodeTiled refused a q/k/v tensor map";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // extern "C"
