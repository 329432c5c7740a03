// Causal GQA flash attention, backward, in bfloat16 for Hopper (sm_90a):
// TMA loads, wgmma products, a warp-specialised producer/consumer pipeline,
// as in the forward (flash_attention_wgmma.cu).  The "wgmma" route of
// ops.py::bwd_route (bf16, D in {64, 80, 128}; ops.py::launch_bwd copies an
// input whose pointer or strides are off 16 bytes first);
// flash_attention_bwd.cu keeps the other inputs.
//
// Replaces: nothing on the TPU.  It is the gradient of the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py:42 (_kernel), whose
// reference trains through XLA's autodiff of src/repro/models/attention.py:97.
// Oracle: ref.py::flash_bwd_ref.  Same function as flash_attention_bwd.cu:
//
//   P  = exp(scale q k^T - LSE),  dV = P^T dO,  delta = rowsum(dO o o),
//   dS = P o (dO V^T - delta),    dQ = scale dS K,  dK = scale dS^T Q,
//
// every sum in f32, P and dS rounded to bf16 as product operands, each of
// dq, dk, dv written once: no atomics, a fixed loop order, bitwise
// repeatable.  LSE is the forward's (flash_attention_wgmma.cu writes it
// beside o), so no kernel recomputes it.
//
// What bounds it: operations.  By the usual count a backward is 2.5x the
// causal forward's 4 B H D S(S+1)/2; at the training shape
// (4, 4096, 16, 8, 128) that is 6.9e11, 0.695 ms at the 989 TFLOP/s bf16
// peak, against 0.10 ms for its bytes.  This design runs 7 causal products
// (dkdv 4, dq 3; 1.75x the 4 of that count), so its own floor is 0.97 ms.
// What the design does about it:
//
//   * Three kernels a call on the caller's stream: bwd_prep
//     (flash_attention_bwd.cu: delta, and the forward's LSE in log2 units,
//     both padded to a row pitch of S rounded up to 128: LSE +inf, delta 0,
//     so a padded row has P = 0), then bwd_dkdv and bwd_dq below.
//   * Both kernels have the forward's skeleton: a persistent grid (one CTA
//     per SM walking items blockIdx.x + k gridDim.x, longest causal bands
//     first), 3 warpgroups, warpgroup 0 a producer whose one thread issues
//     TMA loads of 128-byte swizzled boxes into rings on mbarriers,
//     `setmaxnreg` 24 for it and 240 for the two consumer warpgroups.
//     Every product is wgmma with f32 accumulators in registers; operands
//     that are transposed in the math are read MN-major through the
//     transpose bit, so nothing is transposed in memory.
//   * bwd_dq: an item is (128-row q tile, b, query head); each consumer
//     warpgroup owns 64 rows.  Q and dO of the item are double-buffered
//     across items; K and V come through a 3-stage ring of 64-key tiles
//     (2 stages: 21% slower at the training shape).
//     Per tile: S = Q K^T and dP = dO V^T (m64n64, A and B from shared
//     memory, one group), P = exp2(S c - LSE2) and dS = P o (dP - delta)
//     in registers, dS packed to bf16 as the register-A operand of
//     dQ += dS K (m64nD, K MN-major).  S and dP of tile j + 1 are issued
//     with dQ of tile j, and dS of tile j + 1 is formed while that runs.
//     64-key tiles: S, dP and dQ take 32 + 32 + 64 registers at D = 128
//     (D = 80: 32 + 32 + 40), dS 16; at 128 keys the three accumulators
//     alone would take 192.
//   * bwd_dkdv: an item is (128-key tile, b, kv head); each consumer
//     warpgroup owns 64 keys and keeps dK and dV (2 x 64 registers at
//     D = 128, 2 x 40 at D = 80) for the whole item.  K and V load once an item; Q, dO, LSE2 and delta of
//     each 64-query step come through a 2-stage ring.  The steps run the G
//     query heads of the kv head in turn, each over the query steps that
//     see the key tile (causal, inside the window).  Per step:
//     S^T = K Q^T and dP^T = V dO^T (m64n64, from shared memory, two
//     groups), P^T when S^T is done, dV += P^T dO issued while dS^T =
//     P^T o (dP^T - delta) is formed, then dK += dS^T Q (m64nD, register
//     A, dO and Q MN-major).  Items are numbered key tile slowest, first
//     tile first: the heaviest items start first.
//   * Masks: the causal and window tests run only on tiles that cross the
//     diagonal or the window's lower edge (and, in dkdv, on the ragged last
//     query step); every other tile of the band runs unmasked.  Rows and
//     keys past S come back zero-filled from TMA and are masked or carry
//     P = 0 through the padded LSE; they are not stored.
//
//   * D = 80 (zamba2-2.7b's head dim): each row of a Q, K, V or dO tile is
//     a 64-column box under the 128-byte swizzle and a 16-column box
//     (32-byte rows) under the 32-byte swizzle (hopper.cuh, TileBoxes),
//     since an MN-major operand under the 128-byte swizzle spans whole
//     64-column atoms.  The products over D (S, dP, S^T, dP^T) run 4
//     k-steps on the first box and a fifth on the second; each k-step of
//     those into D (dQ, dV, dK) is an n64 product on the first box and an
//     n16 product on the second.  No product spans padding.
//
// Instantiated for D in {64, 80, 128}.

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash::sm90;

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536, "register file");

constexpr int kDqRows = 128;  // bwd_dq: query rows an item
constexpr int kDqKeys = 64;   // bwd_dq: keys a K/V tile
constexpr int kDqSlots = 2;   // bwd_dq: Q/dO buffers (items in flight)
constexpr int kDqStages = 3;  // bwd_dq: K/V ring depth
constexpr int kKvKeys = 128;  // bwd_dkdv: keys an item
constexpr int kKvQ = 64;      // bwd_dkdv: queries a step
constexpr int kKvStages = 2;  // bwd_dkdv: Q/dO/LSE2/delta ring depth

struct Args {
  __nv_bfloat16 *dq, *dk, *dv;
  long long dqsb, dqss, dqsh, dksb, dkss, dksh, dvsb, dvss, dvsh;  // element strides
  const float* lse2;   // (B, H, pitch): the forward's LSE in log2 units, +inf past S
  const float* delta;  // (B, H, pitch): rowsum(dO o o), 0 past S
  int B, S, H, K, G, pitch;
  int window;        // <= 0: none
  float scale_log2;  // log2(e) / sqrt(D)
  float scale;       // 1 / sqrt(D)
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int window) {
  return kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ uint32_t parity(int t, int stages) {
  return static_cast<uint32_t>((t / stages) & 1);
}

// Issue acc = A B^T over D: A (this warpgroup's 64 rows) and B (N rows),
// both K-major 128-byte swizzled tiles of D / 64 boxes, `a_box` and `b_box`
// bytes apart; 4 k-steps a box, 32 bytes apart inside a box row.  At D = 80
// a fifth k-step reads the 16-column boxes under the 32-byte swizzle
// (`a_tail`: A's rows of it, `b_tail`; 8-row stride 256 B).  Not
// committed.  The caller pins the accumulator and fences first.
template <int N, int D>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a, uint32_t a_tail,
                                         int a_box, uint32_t b, uint32_t b_tail, int b_box) {
#pragma unroll
  for (int kk = 0; kk < 4 * (D / kBoxCols); ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<N>(acc, sw128_desc(a + (kk / 4) * a_box + col, 16, 1024),
                sw128_desc(b + (kk / 4) * b_box + col, 16, 1024), kk > 0);
  }
  if constexpr (D % kBoxCols != 0)
    wgmma_ss<N>(acc, sw32_desc(a_tail, 16, 8 * kTailRowBytes),
                sw32_desc(b_tail, 16, 8 * kTailRowBytes), 1);
}

// Issue acc += A B: A from registers (64 x 16 k-steps), B a 16-row k-step
// apart MN-major tile of D columns in boxes `b_box` bytes apart.  At D = 80
// each k-step is an n64 product on the 64-column box and an n16 product on
// the 16-column box at `b_tail` (16 rows 512 B apart, the 8-row stride
// 256 B) into the accumulator's columns 0-63 and 64-79.  Not committed.
template <int KS, int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&f)[KS][4],
                                         uint32_t b, uint32_t b_tail, int b_box) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (D % kBoxCols == 0) {
      wgmma_rs<D>(acc, f[kk], sw128_desc(b + kk * 16 * kRowBytes, b_box, 1024));
    } else {
      wgmma_rs<kBoxCols>(acc_cols<0, kBoxCols>(acc), f[kk],
                         sw128_desc(b + kk * 16 * kRowBytes, b_box, 1024));
      wgmma_rs<kTailCols>(acc_cols<kBoxCols, kTailCols>(acc), f[kk],
                          sw32_desc(b_tail + kk * 16 * kTailRowBytes, b_box,
                                    8 * kTailRowBytes));
    }
  }
}

// ============================================================================
// bwd_dq
// ============================================================================

template <int D>
struct DqLayout {
  using QT = TileBoxes<D, kDqRows>;
  using KT = TileBoxes<D, kDqKeys>;
  static constexpr int kBoxes = QT::kFull;
  static constexpr bool kTail = QT::kTail;             // D = 80: a 16-column box a tile
  static constexpr int kRowBox = QT::kBox;             // one box of an item's 128 rows
  static constexpr int kKeyBox = KT::kBox;             // one box of a 64-key tile
  static constexpr int kQTile = QT::kBytes;            // Q or dO of an item
  static constexpr int kKTile = KT::kBytes;            // K or V tile
  static constexpr int kQTail = QT::kTailOff;          // the 16-column box of Q, dO
  static constexpr int kKTail = KT::kTailOff;          // and of K, V
  static constexpr int kSlot = 2 * kQTile;             // Q then dO
  static constexpr int kK = kDqSlots * kSlot;         // K of stage s at kK + s * kStage
  static constexpr int kStage = 2 * kKTile;            // K then V
  static constexpr int kBar = kK + kDqStages * kStage;
  // q_full[slots], q_empty[slots], k_full[S], v_full[S], k_empty[S], v_empty[S]
  static constexpr int kBars = 2 * kDqSlots + 4 * kDqStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + the swizzle atom alignment
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int D>
struct DqSmem {
  using L = DqLayout<D>;
  uint32_t base;
  __device__ uint32_t q(int s) const { return base + s * L::kSlot; }
  __device__ uint32_t dout(int s) const { return q(s) + L::kQTile; }
  __device__ uint32_t k(int s) const { return base + L::kK + s * L::kStage; }
  __device__ uint32_t v(int s) const { return k(s) + L::kKTile; }
  __device__ uint32_t bar(int i) const { return base + L::kBar + 8u * i; }
  __device__ uint32_t q_full(int s) const { return bar(s); }
  __device__ uint32_t q_empty(int s) const { return bar(kDqSlots + s); }
  __device__ uint32_t k_full(int s) const { return bar(2 * kDqSlots + s); }
  __device__ uint32_t v_full(int s) const { return bar(2 * kDqSlots + kDqStages + s); }
  __device__ uint32_t k_empty(int s) const { return bar(2 * kDqSlots + 2 * kDqStages + s); }
  __device__ uint32_t v_empty(int s) const { return bar(2 * kDqSlots + 3 * kDqStages + s); }
};

// A work item of bwd_dq: a 128-row q tile of one (batch, query head) and
// the 64-key tiles that meet its band, from the one holding the window's
// first key to the one holding its last real row.  q tile slowest and
// last-first, query head fastest (as the forward).
struct DqItem {
  int b, h, q0, j_begin, n_tiles;
};

__device__ __forceinline__ DqItem dq_item(int idx, const Args& a, int n_q_tiles) {
  DqItem w;
  const int qt = n_q_tiles - 1 - idx / (a.B * a.H);
  const int rest = idx % (a.B * a.H);
  w.b = rest / a.H;
  w.h = rest % a.H;
  w.q0 = qt * kDqRows;
  w.j_begin = a.window > 0 ? max(0, w.q0 - a.window + 1) / kDqKeys : 0;
  w.n_tiles = min(a.S - 1, w.q0 + kDqRows - 1) / kDqKeys - w.j_begin + 1;
  return w;
}

// dS = P o (dP - delta) of one 64-key tile in place of S, P = exp2(S c -
// LSE2).  `masked`: the causal and window tests (diagonal and window-edge
// tiles only).
__device__ __forceinline__ void ds_tile(float (&sc)[kDqKeys / 2], const float (&dp)[kDqKeys / 2],
                                        bool masked, int kv0, int tq, int qpos0, int qpos1,
                                        int window, float c, const float (&l2)[2],
                                        const float (&dl)[2]) {
  if (masked) {
#pragma unroll
    for (int e = 0; e < kDqKeys / 2; ++e) {
      const int r = (e >> 1) & 1;
      const int kpos = kv0 + 8 * (e / 4) + 2 * tq + (e & 1);
      const float p = visible(r ? qpos1 : qpos0, kpos, window)
                          ? exp2_approx(fmaf(sc[e], c, -l2[r])) : 0.f;
      sc[e] = p * (dp[e] - dl[r]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kDqKeys / 2; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = exp2_approx(fmaf(sc[e], c, -l2[r])) * (dp[e] - dl[r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_q1,
                 const __grid_constant__ CUtensorMap tm_do1,
                 const __grid_constant__ CUtensorMap tm_k1,
                 const __grid_constant__ CUtensorMap tm_v1, const Args a, const int n_q_tiles,
                 const int n_items) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const DqSmem<D> sm{(smem_addr(smem_raw) + 1023u) & ~1023u};

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < kDqSlots; ++s) {
      mbar_init(sm.q_full(s), 1);
      mbar_init(sm.q_empty(s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.k_empty(s), 8);
      mbar_init(sm.v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO of each item, then its K/V tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      int t = 0;  // K/V tiles issued so far
      for (int idx = blockIdx.x, n = 0; idx < n_items; idx += gridDim.x, ++n) {
        const DqItem w = dq_item(idx, a, n_q_tiles);
        const int kh = w.h / a.G;
        const int slot = n % kDqSlots;
        mbar_wait(sm.q_empty(slot), parity(n, kDqSlots) ^ 1);
        mbar_expect_tx(sm.q_full(slot), 2 * L::kQTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(sm.q(slot) + x * L::kRowBox, &tm_q, sm.q_full(slot), x * kBoxCols, w.h, w.q0,
                   w.b);
          tma_load(sm.dout(slot) + x * L::kRowBox, &tm_do, sm.q_full(slot), x * kBoxCols, w.h,
                   w.q0, w.b);
        }
        if constexpr (L::kTail) {
          tma_load(sm.q(slot) + L::kQTail, &tm_q1, sm.q_full(slot), L::kBoxes * kBoxCols, w.h,
                   w.q0, w.b);
          tma_load(sm.dout(slot) + L::kQTail, &tm_do1, sm.q_full(slot), L::kBoxes * kBoxCols,
                   w.h, w.q0, w.b);
        }
        for (int i = 0; i < w.n_tiles; ++i, ++t) {
          const int s = t % kDqStages;
          const uint32_t free_parity = parity(t, kDqStages) ^ 1;
          const int kv0 = (w.j_begin + i) * kDqKeys;
          mbar_wait(sm.k_empty(s), free_parity);
          mbar_expect_tx(sm.k_full(s), L::kKTile);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(sm.k(s) + x * L::kKeyBox, &tm_k, sm.k_full(s), x * kBoxCols, kh, kv0, w.b);
          if constexpr (L::kTail)
            tma_load(sm.k(s) + L::kKTail, &tm_k1, sm.k_full(s), L::kBoxes * kBoxCols, kh, kv0,
                     w.b);
          mbar_wait(sm.v_empty(s), free_parity);
          mbar_expect_tx(sm.v_full(s), L::kKTile);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(sm.v(s) + x * L::kKeyBox, &tm_v, sm.v_full(s), x * kBoxCols, kh, kv0, w.b);
          if constexpr (L::kTail)
            tma_load(sm.v(s) + L::kKTail, &tm_v1, sm.v_full(s), L::kBoxes * kBoxCols, kh, kv0,
                     w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each q tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int tq = lane % 4;
  const int row0 = cw * 64 + warp * 16 + lane / 4;  // accumulator row; + 8: the second
  const float c = a.scale_log2;

  float dqa[D / 2];
  float sc[kDqKeys / 2], dp[kDqKeys / 2];
  uint32_t dsf[kDqKeys / 16][4];
  int t = 0;  // K/V tiles consumed so far, as the producer counts them
  for (int idx = blockIdx.x, n = 0; idx < n_items; idx += gridDim.x, ++n) {
    const DqItem w = dq_item(idx, a, n_q_tiles);
    const int slot = n % kDqSlots;
    const int qpos0 = w.q0 + row0, qpos1 = qpos0 + 8;
    const int first = w.q0 + cw * 64, last = first + 63;  // this warpgroup's rows
    const auto masked = [&](int kv0) {
      return kv0 + kDqKeys - 1 > first || (a.window > 0 && kv0 <= last - a.window);
    };
    // the pitch holds every row of the tile; rows past S read +inf and 0
    const long long rb = (static_cast<long long>(w.b) * a.H + w.h) * a.pitch;
    const float l2[2] = {a.lse2[rb + qpos0], a.lse2[rb + qpos1]};
    const float dl[2] = {a.delta[rb + qpos0], a.delta[rb + qpos1]};
    const uint32_t q_rows = sm.q(slot) + cw * 64 * kRowBytes;
    const uint32_t do_rows = sm.dout(slot) + cw * 64 * kRowBytes;
    const uint32_t q_tail = sm.q(slot) + L::kQTail + cw * 64 * kTailRowBytes;  // D = 80
    const uint32_t do_tail = sm.dout(slot) + L::kQTail + cw * 64 * kTailRowBytes;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    mbar_wait(sm.q_full(slot), parity(n, kDqSlots));

    // Tile 0's S and dP, then per tile: S and dP of tile i with dQ of
    // tile i - 1, dS of tile i while that runs.
    {
      const int s = t % kDqStages;
      mbar_wait(sm.k_full(s), parity(t, kDqStages));
      mbar_wait(sm.v_full(s), parity(t, kDqStages));
      pin(sc);
      pin(dp);
      wg_fence();
      issue_ss<kDqKeys, D>(sc, q_rows, q_tail, L::kRowBox, sm.k(s), sm.k(s) + L::kKTail,
                           L::kKeyBox);
      issue_ss<kDqKeys, D>(dp, do_rows, do_tail, L::kRowBox, sm.v(s), sm.v(s) + L::kKTail,
                           L::kKeyBox);
      wg_commit();
      wg_wait<0>();
      pin(sc);
      pin(dp);
      release(sm.v_empty(s), lane);
      const int kv0 = w.j_begin * kDqKeys;
      ds_tile(sc, dp, masked(kv0), kv0, tq, qpos0, qpos1, a.window, c, l2, dl);
      pack_a<kDqKeys>(sc, dsf);
    }
    for (int i = 1; i < w.n_tiles; ++i) {
      const int tc = t + i, tp = tc - 1;
      const int s = tc % kDqStages, sp = tp % kDqStages;
      const int kv0 = (w.j_begin + i) * kDqKeys;
      mbar_wait(sm.k_full(s), parity(tc, kDqStages));
      mbar_wait(sm.v_full(s), parity(tc, kDqStages));
      pin(sc);
      pin(dp);
      pin(dqa);
      wg_fence();
      issue_ss<kDqKeys, D>(sc, q_rows, q_tail, L::kRowBox, sm.k(s), sm.k(s) + L::kKTail,
                           L::kKeyBox);
      issue_ss<kDqKeys, D>(dp, do_rows, do_tail, L::kRowBox, sm.v(s), sm.v(s) + L::kKTail,
                           L::kKeyBox);
      wg_commit();
      issue_rs<kDqKeys / 16, D>(dqa, dsf, sm.k(sp), sm.k(sp) + L::kKTail, L::kKeyBox);
      wg_commit();
      wg_wait<1>();  // S and dP of tile i are done; dQ of tile i - 1 may still run
      pin(sc);
      pin(dp);
      release(sm.v_empty(s), lane);
      ds_tile(sc, dp, masked(kv0), kv0, tq, qpos0, qpos1, a.window, c, l2, dl);
      wg_wait<0>();
      hold(dsf);
      pin(dqa);
      release(sm.k_empty(sp), lane);
      pack_a<kDqKeys>(sc, dsf);
    }
    const int tl = t + w.n_tiles - 1;
    pin(dqa);
    wg_fence();
    issue_rs<kDqKeys / 16, D>(dqa, dsf, sm.k(tl % kDqStages),
                              sm.k(tl % kDqStages) + L::kKTail, L::kKeyBox);
    wg_commit();
    wg_wait<0>();
    hold(dsf);
    pin(dqa);
    release(sm.k_empty(tl % kDqStages), lane);
    release(sm.q_empty(slot), lane);
    t += w.n_tiles;

    // dq = scale dQ, two bf16 per store; rows past S are dropped.
    __nv_bfloat16* out = a.dq + w.b * a.dqsb + w.h * a.dqsh + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r ? qpos1 : qpos0;
      if (qpos >= a.S) continue;
      __nv_bfloat16* row = out + qpos * a.dqss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(dqa[4 * j + 2 * r] * a.scale, dqa[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

// ============================================================================
// bwd_dkdv
// ============================================================================

template <int D>
struct KvLayout {
  using KT = TileBoxes<D, kKvKeys>;
  using QT = TileBoxes<D, kKvQ>;
  static constexpr int kBoxes = KT::kFull;
  static constexpr bool kTail = KT::kTail;             // D = 80: a 16-column box a tile
  static constexpr int kKeyBox = KT::kBox;             // one box of an item's 128 keys
  static constexpr int kQBox = QT::kBox;               // one box of a 64-query step
  static constexpr int kKTile = KT::kBytes;            // K or V of an item
  static constexpr int kQTile = QT::kBytes;            // Q or dO of a step
  static constexpr int kKTail = KT::kTailOff;          // the 16-column box of K, V
  static constexpr int kQTail = QT::kTailOff;          // and of Q, dO
  static constexpr int kV = kKTile;
  static constexpr int kRing = 2 * kKTile;
  // Q, dO, LSE2 (kKvQ floats), delta (kKvQ floats), rounded up to the
  // swizzle atom
  static constexpr int kStage = (2 * kQTile + 2 * kKvQ * 4 + 1023) / 1024 * 1024;
  static constexpr int kBar = kRing + kKvStages * kStage;
  // kv_full, kv_empty, qd_full[S], qd_empty[S]
  static constexpr int kBars = 2 + 2 * kKvStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int D>
struct KvSmem {
  using L = KvLayout<D>;
  uint32_t base;
  __device__ uint32_t k() const { return base; }
  __device__ uint32_t v() const { return base + L::kV; }
  __device__ uint32_t q(int s) const { return base + L::kRing + s * L::kStage; }
  __device__ uint32_t dout(int s) const { return q(s) + L::kQTile; }
  __device__ uint32_t lse2(int s) const { return q(s) + 2 * L::kQTile; }
  __device__ uint32_t delta(int s) const { return lse2(s) + kKvQ * 4; }
  __device__ uint32_t bar(int i) const { return base + L::kBar + 8u * i; }
  __device__ uint32_t kv_full() const { return bar(0); }
  __device__ uint32_t kv_empty() const { return bar(1); }
  __device__ uint32_t qd_full(int s) const { return bar(2 + s); }
  __device__ uint32_t qd_empty(int s) const { return bar(2 + kKvStages + s); }
};

// A work item of bwd_dkdv: a 128-key tile of one (batch, kv head) and the
// 64-query steps that see it, from the key tile's own first query to the
// last query inside the window (or S), for each of the G query heads.
// Key tile slowest and first-first (the longest causal bands), kv head
// fastest.
struct KvItem {
  int b, kh, kv0, n_steps;  // n_steps a query head
};

__device__ __forceinline__ KvItem kv_item(int idx, const Args& a) {
  KvItem w;
  const int kt = idx / (a.B * a.K);
  const int rest = idx % (a.B * a.K);
  w.b = rest / a.K;
  w.kh = rest % a.K;
  w.kv0 = kt * kKvKeys;
  const int q_last = a.window > 0 ? min(a.S - 1, w.kv0 + kKvKeys - 1 + a.window - 1) : a.S - 1;
  w.n_steps = q_last / kKvQ - w.kv0 / kKvQ + 1;
  return w;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_lse2,
                   const __grid_constant__ CUtensorMap tm_delta,
                   const __grid_constant__ CUtensorMap tm_q1,
                   const __grid_constant__ CUtensorMap tm_do1,
                   const __grid_constant__ CUtensorMap tm_k1,
                   const __grid_constant__ CUtensorMap tm_v1, const Args a,
                   const int n_items) {
  using L = KvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const KvSmem<D> sm{(smem_addr(smem_raw) + 1023u) & ~1023u};
  const unsigned char* smem = smem_raw + (sm.base - smem_addr(smem_raw));  // sm.base, generic

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    mbar_init(sm.kv_full(), 1);
    mbar_init(sm.kv_empty(), 8);  // one arrival per consumer warp
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(sm.qd_full(s), 1);
      mbar_init(sm.qd_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V of each item, then its steps' Q, dO, LSE2, delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      int t = 0;  // steps issued so far
      for (int idx = blockIdx.x, n = 0; idx < n_items; idx += gridDim.x, ++n) {
        const KvItem w = kv_item(idx, a);
        mbar_wait(sm.kv_empty(), (n & 1) ^ 1);
        mbar_expect_tx(sm.kv_full(), 2 * L::kKTile);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(sm.k() + x * L::kKeyBox, &tm_k, sm.kv_full(), x * kBoxCols, w.kh, w.kv0, w.b);
          tma_load(sm.v() + x * L::kKeyBox, &tm_v, sm.kv_full(), x * kBoxCols, w.kh, w.kv0, w.b);
        }
        if constexpr (L::kTail) {
          tma_load(sm.k() + L::kKTail, &tm_k1, sm.kv_full(), L::kBoxes * kBoxCols, w.kh, w.kv0,
                   w.b);
          tma_load(sm.v() + L::kKTail, &tm_v1, sm.kv_full(), L::kBoxes * kBoxCols, w.kh, w.kv0,
                   w.b);
        }
        for (int g = 0; g < a.G; ++g) {
          const int h = w.kh * a.G + g;
          const int row = w.b * a.H + h;
          for (int j = 0; j < w.n_steps; ++j, ++t) {
            const int s = t % kKvStages;
            const int q0 = w.kv0 + j * kKvQ;
            mbar_wait(sm.qd_empty(s), parity(t, kKvStages) ^ 1);
            mbar_expect_tx(sm.qd_full(s), 2 * L::kQTile + 2 * kKvQ * 4);
#pragma unroll
            for (int x = 0; x < L::kBoxes; ++x) {
              tma_load(sm.q(s) + x * L::kQBox, &tm_q, sm.qd_full(s), x * kBoxCols, h, q0, w.b);
              tma_load(sm.dout(s) + x * L::kQBox, &tm_do, sm.qd_full(s), x * kBoxCols, h, q0,
                       w.b);
            }
            if constexpr (L::kTail) {
              tma_load(sm.q(s) + L::kQTail, &tm_q1, sm.qd_full(s), L::kBoxes * kBoxCols, h, q0,
                       w.b);
              tma_load(sm.dout(s) + L::kQTail, &tm_do1, sm.qd_full(s), L::kBoxes * kBoxCols, h,
                       q0, w.b);
            }
            tma_load_2d(sm.lse2(s), &tm_lse2, sm.qd_full(s), q0, row);
            tma_load_2d(sm.delta(s), &tm_delta, sm.qd_full(s), q0, row);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int tq = lane % 4;
  const int row0 = cw * 64 + warp * 16 + lane / 4;  // accumulator row (key); + 8: the second
  const float c = a.scale_log2;
  const uint32_t k_rows = sm.k() + cw * 64 * kRowBytes;
  const uint32_t v_rows = sm.v() + cw * 64 * kRowBytes;
  const uint32_t k_tail = sm.k() + L::kKTail + cw * 64 * kTailRowBytes;  // D = 80
  const uint32_t v_tail = sm.v() + L::kKTail + cw * 64 * kTailRowBytes;

  float dva[D / 2], dka[D / 2];
  float st[kKvQ / 2], dpt[kKvQ / 2];
  uint32_t pf[kKvQ / 16][4], sf[kKvQ / 16][4];
  int t = 0;  // steps consumed so far
  for (int idx = blockIdx.x, n = 0; idx < n_items; idx += gridDim.x, ++n) {
    const KvItem w = kv_item(idx, a);
    const int kpos0 = w.kv0 + row0, kpos1 = kpos0 + 8;
    const int first = w.kv0 + cw * 64, last = first + 63;  // this warpgroup's keys
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;
    mbar_wait(sm.kv_full(), n & 1);
    for (int g = 0; g < a.G; ++g) {
      for (int j = 0; j < w.n_steps; ++j, ++t) {
        const int s = t % kKvStages;
        const int q0 = w.kv0 + j * kKvQ;
        // a query before a key of this warpgroup, one beyond the window, or
        // a query past S
        const bool masked = q0 < last || (a.window > 0 && q0 + kKvQ - 1 - first >= a.window) ||
                            q0 + kKvQ > a.S;
        mbar_wait(sm.qd_full(s), parity(t, kKvStages));
        pin(st);
        pin(dpt);
        wg_fence();
        issue_ss<kKvQ, D>(st, k_rows, k_tail, L::kKeyBox, sm.q(s), sm.q(s) + L::kQTail,
                          L::kQBox);
        wg_commit();
        issue_ss<kKvQ, D>(dpt, v_rows, v_tail, L::kKeyBox, sm.dout(s), sm.dout(s) + L::kQTail,
                          L::kQBox);
        wg_commit();
        // this thread's query columns 8 jj + 2 tq + {0, 1}: LSE2 and delta
        const float* lse_s = reinterpret_cast<const float*>(smem + (sm.lse2(s) - sm.base));
        const float* del_s = lse_s + kKvQ;
        wg_wait<1>();  // S^T is done
        pin(st);
#pragma unroll
        for (int jj = 0; jj < kKvQ / 8; ++jj) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * jj + 2 * tq);
#pragma unroll
          for (int e = 4 * jj; e < 4 * jj + 4; ++e) {
            const float lse = (e & 1) ? l2.y : l2.x;
            float p = exp2_approx(fmaf(st[e], c, -lse));
            if (masked) {
              const int qpos = q0 + 8 * jj + 2 * tq + (e & 1);
              const int kpos = (e & 2) ? kpos1 : kpos0;
              p = visible(qpos, kpos, a.window) && qpos < a.S ? p : 0.f;
            }
            st[e] = p;
          }
        }
        pack_a<kKvQ>(st, pf);
        pin(dva);
        wg_fence();
        issue_rs<kKvQ / 16, D>(dva, pf, sm.dout(s), sm.dout(s) + L::kQTail,
                               L::kQBox);  // dV += P^T dO
        wg_commit();
        wg_wait<1>();  // dP^T is done; dV may still run
        pin(dpt);
#pragma unroll
        for (int jj = 0; jj < kKvQ / 8; ++jj) {
          const float2 d2 = *reinterpret_cast<const float2*>(del_s + 8 * jj + 2 * tq);
#pragma unroll
          for (int e = 4 * jj; e < 4 * jj + 4; ++e)
            dpt[e] = st[e] * (dpt[e] - ((e & 1) ? d2.y : d2.x));
        }
        pack_a<kKvQ>(dpt, sf);
        pin(dka);
        wg_fence();
        issue_rs<kKvQ / 16, D>(dka, sf, sm.q(s), sm.q(s) + L::kQTail,
                               L::kQBox);  // dK += dS^T Q
        wg_commit();
        wg_wait<0>();
        hold(pf);
        hold(sf);
        pin(dva);
        pin(dka);
        release(sm.qd_empty(s), lane);
      }
    }
    release(sm.kv_empty(), lane);

    // dk = scale dK, dv = dV, two bf16 per store; keys past S are dropped.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = r ? kpos1 : kpos0;
      if (kpos >= a.S) continue;
      __nv_bfloat16* krow = a.dk + w.b * a.dksb + kpos * a.dkss + w.kh * a.dksh + 2 * tq;
      __nv_bfloat16* vrow = a.dv + w.b * a.dvsb + kpos * a.dvss + w.kh * a.dvsh + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(krow + 8 * j) =
            pack_bf16(dka[4 * j + 2 * r] * a.scale, dka[4 * j + 2 * r + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// The "1" maps: the 16-column boxes at d = 64 under the 32-byte swizzle
// (D = 80; copies of the 64-column maps, unread, at D = 64 and 128).
struct Maps {
  CUtensorMap q128, do128, k64, v64;                // bwd_dq
  CUtensorMap q64, do64, k128, v128, lse2, delta;   // bwd_dkdv
  CUtensorMap q128_1, do128_1, k64_1, v64_1;        // bwd_dq, D = 80
  CUtensorMap q64_1, do64_1, k128_1, v128_1;        // bwd_dkdv, D = 80
};

template <int D>
int launch(const Maps& m, const Args& a, cudaStream_t st) {
  const int sms = sm_count();
  if (sms < 0) return -sms;
  int err;
  const int n_k_items = (a.S + kKvKeys - 1) / kKvKeys * a.B * a.K;
  auto dkdv = bwd_dkdv_wgmma<D>;
  if ((err = allow_smem(dkdv, KvLayout<D>::kBytes))) return err;
  dkdv<<<n_k_items < sms ? n_k_items : sms, kThreads, KvLayout<D>::kBytes, st>>>(
      m.q64, m.do64, m.k128, m.v128, m.lse2, m.delta, m.q64_1, m.do64_1, m.k128_1, m.v128_1, a,
      n_k_items);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int n_q_tiles = (a.S + kDqRows - 1) / kDqRows;
  const int n_q_items = n_q_tiles * a.B * a.H;
  auto dq = bwd_dq_wgmma<D>;
  if ((err = allow_smem(dq, DqLayout<D>::kBytes))) return err;
  dq<<<n_q_items < sms ? n_q_items : sms, kThreads, DqLayout<D>::kBytes, st>>>(
      m.q128, m.do128, m.k64, m.v64, m.q128_1, m.do128_1, m.k64_1, m.v64_1, a, n_q_tiles,
      n_q_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// flash_attention_bwd.cu's signature (BWD_ARGS): lse is the forward's
// (B, H, S) natural-log LSE, delta the scratch of
// flash_attention_bwd_scratch_floats(B, H, S) floats (delta, then LSE2).
// One call runs bwd_prep, bwd_dkdv and bwd_dq.
int flash_attention_bwd_wgmma_bf16(BWD_ARGS) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const long long n_rows = static_cast<long long>(B) * H;
  if (K <= 0 || H % K != 0 || n_rows > 65535 ||
      (S + kDqRows - 1LL) / kDqRows * n_rows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // The TMA maps' layout test on q, k, v and dO (ops.py::launch_bwd copies
  // an input that fails it).
  if ((D != 64 && D != 80 && D != 128) || !tma_ok(q, B, S, H, qsb, qss, qsh) ||
      !tma_ok(k, B, S, K, ksb, kss, ksh) || !tma_ok(v, B, S, K, vsb, vss, vsh) ||
      !tma_ok(dout, B, S, H, dosb, doss, dosh))
    return flash::kErrRoute;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return flash::kErrNoEncoder;
  const long long pitch = flash::bwd_pitch(S);
  float* delta_buf = static_cast<float*>(delta);
  float* lse2 = delta_buf + n_rows * pitch;
  Maps m;
  if (!encode(enc, &m.q128, q, B, S, H, D, qsb, qss, qsh, kDqRows) ||
      !encode(enc, &m.do128, dout, B, S, H, D, dosb, doss, dosh, kDqRows) ||
      !encode(enc, &m.k64, k, B, S, K, D, ksb, kss, ksh, kDqKeys) ||
      !encode(enc, &m.v64, v, B, S, K, D, vsb, vss, vsh, kDqKeys) ||
      !encode(enc, &m.q64, q, B, S, H, D, qsb, qss, qsh, kKvQ) ||
      !encode(enc, &m.do64, dout, B, S, H, D, dosb, doss, dosh, kKvQ) ||
      !encode(enc, &m.k128, k, B, S, K, D, ksb, kss, ksh, kKvKeys) ||
      !encode(enc, &m.v128, v, B, S, K, D, vsb, vss, vsh, kKvKeys) ||
      !encode_rows_f32(enc, &m.lse2, lse2, n_rows, pitch, kKvQ) ||
      !encode_rows_f32(enc, &m.delta, delta_buf, n_rows, pitch, kKvQ))
    return flash::kErrTensorMap;
  if (D == 80) {
    const int c = kTailCols;
    const auto sw = CU_TENSOR_MAP_SWIZZLE_32B;
    if (!encode(enc, &m.q128_1, q, B, S, H, D, qsb, qss, qsh, kDqRows, c, sw) ||
        !encode(enc, &m.do128_1, dout, B, S, H, D, dosb, doss, dosh, kDqRows, c, sw) ||
        !encode(enc, &m.k64_1, k, B, S, K, D, ksb, kss, ksh, kDqKeys, c, sw) ||
        !encode(enc, &m.v64_1, v, B, S, K, D, vsb, vss, vsh, kDqKeys, c, sw) ||
        !encode(enc, &m.q64_1, q, B, S, H, D, qsb, qss, qsh, kKvQ, c, sw) ||
        !encode(enc, &m.do64_1, dout, B, S, H, D, dosb, doss, dosh, kKvQ, c, sw) ||
        !encode(enc, &m.k128_1, k, B, S, K, D, ksb, kss, ksh, kKvKeys, c, sw) ||
        !encode(enc, &m.v128_1, v, B, S, K, D, vsb, vss, vsh, kKvKeys, c, sw))
      return flash::kErrTensorMap;
  } else {
    m.q128_1 = m.q128;
    m.do128_1 = m.do128;
    m.k64_1 = m.k64;
    m.v64_1 = m.v64;
    m.q64_1 = m.q64;
    m.do64_1 = m.do64;
    m.k128_1 = m.k128;
    m.v128_1 = m.v128;
  }
  int err = flash::bwd_prep_bf16(o, dout, static_cast<const float*>(lse), delta_buf, lse2, B, S,
                                 H, D, osb, oss, osh, dosb, doss, dosh, stream);
  if (err) return err;
  Args a;
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dqsb = dqsb;
  a.dqss = dqss;
  a.dqsh = dqsh;
  a.dksb = dksb;
  a.dkss = dkss;
  a.dksh = dksh;
  a.dvsb = dvsb;
  a.dvss = dvss;
  a.dvsh = dvsh;
  a.lse2 = lse2;
  a.delta = delta_buf;
  a.B = B;
  a.S = S;
  a.H = H;
  a.K = K;
  a.G = H / K;
  a.pitch = static_cast<int>(pitch);
  a.window = window;
  // the forward's scales, rounded once from double
  a.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch<128>(m, a, st) : D == 80 ? launch<80>(m, a, st) : launch<64>(m, a, st);
}

// Dynamic shared memory of one CTA of bwd_dkdv (which = 0) or bwd_dq
// (which = 1) at head dim D, for reports.
int flash_attention_bwd_wgmma_smem_bytes(int which, int D) {
  if (which == 0)
    return D == 128 ? KvLayout<128>::kBytes
           : D == 80 ? KvLayout<80>::kBytes
           : D == 64 ? KvLayout<64>::kBytes
                     : 0;
  return D == 128 ? DqLayout<128>::kBytes
         : D == 80 ? DqLayout<80>::kBytes
         : D == 64 ? DqLayout<64>::kBytes
                   : 0;
}

}  // extern "C"
