// Causal GQA flash attention (forward) in bfloat16 for Hopper (sm_90a):
// TMA loads, wgmma products, a warp-specialised producer/consumer pipeline.
// Bound to PyTorch through a plain C interface and ctypes.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py::_kernel
// (launched at :131 by flash_attention_pallas; oracle ref.py::flash_ref),
// for bf16 q/k/v with D in {64, 80, 128} and 16-byte aligned base pointers
// and strides (ops.py::route sends other inputs to flash_attention.cu; 80 is
// zamba2-2.7b's head dim).  Same function and numerics:
//
//   o[b, s, k*G + g, :] = softmax_{t <= s, s - t < window}(q . k_t / sqrt(D)) . V
//
// with an f32 online softmax (running max m, sum l, accumulator acc), masked
// scores NEG_INF and their probabilities 0, p rounded to bf16 before the PV
// product, o = acc / max(l, 1e-30).  With an LSE pointer it also writes each
// real row's log-sum-exp of the scaled scores, natural log, f32 (B, H, S):
// (m + log2 l) ln 2 from the log2-unit m and l it already holds (the
// backward's input, ref.py::flash_lse).
//
// What bounds it: the causal band's two products, 4 B H D S(S+1)/2
// operations; at the serve shape (B, S, H, K, D) = (8, 2048, 16, 8, 128)
// 1.375e11 of them, 0.139 ms at 989 TFLOP/s, against 0.060 ms for its
// bytes.  Only wgmma reaches the tensor cores' full rate, so the design is
// built around keeping wgmma fed:
//
//   * Work items are (128-row q tile, batch b, query head h), numbered q
//     tile slowest and last-first (longest causal bands first) and query
//     head fastest (the two query heads of a KV group side by side, reading
//     the same K/V tiles through L2; G is not folded into the rows, which
//     was the TPU's reason to keep 128-wide tiles).  The grid is
//     persistent: one CTA per SM walks items blockIdx.x + k gridDim.x, so
//     the next item's loads and this item's epilogue overlap products.
//   * 3 warpgroups.  Warpgroup 0 is the producer: one thread issues TMA
//     loads of Q (double-buffered across items) and of K and V tiles into
//     a 2-stage ring, each completing on its own mbarrier; the consumers
//     release K and V on their own barriers, K as soon as S is done.
//     `setmaxnreg` drops the producer to 24 registers and lifts the two
//     consumers to 240.
//   * Warpgroups 1 and 2 each own 64 query rows.  Per KV tile:
//       S = Q K^T   wgmma.m64n128k16, A (Q) and B (K, K-major) from
//                   shared memory;
//       softmax on S's accumulator registers: scale * log2(e) folded into
//                   one FFMA before exp2; the causal test only on the tile
//                   that crosses the diagonal, the window test only on
//                   tiles that cross the window's lower edge, every other
//                   tile of the band unmasked;
//       O += P V    wgmma.m64nDk16, A = P from registers (S's accumulator
//                   layout is wgmma's register-A layout once packed to bf16
//                   pairs), B = V from shared memory MN-major (the
//                   transpose bit): no transpose of V anywhere.
//     Software-pipelined within the warpgroup: S of tile j+1 and P V of
//     tile j are issued together, and the softmax of tile j+1 runs while
//     P V of tile j is on the tensor cores.
//   * Tiles: BQ = BK = 128.  At D = 128 a stage of K and V is 64 KB; two
//     stages plus two Q tiles take 192 KB of the 227 KB (D = 80: 20 KB a
//     tile, 120 KB).  The O and S accumulators and P take 64 + 64 + 32
//     registers per consumer thread at D = 128 (D = 80: 40 + 64 + 32),
//     inside 240.  BK = 64 would halve S but double the barrier round trips
//     and softmax reductions per key; 128 fits, so 128.
//   * Shared tiles are TMA boxes of 64 bf16 (128 bytes) x 128 rows with
//     the 128-byte swizzle; a D = 128 row is two boxes.  The wgmma
//     descriptors use the same swizzle: K-major (Q, K) with the 8-row
//     stride 1024 B, stepping 32 B per k16 inside a box; MN-major (V)
//     with the 8-key stride 1024 B and the 64-column box stride 16 KB.
//   * D = 80: a row is one such box and one of 16 bf16 (32 bytes) x 128
//     rows with the 32-byte swizzle (hopper.cuh, TileBoxes): an MN-major
//     operand under the 128-byte swizzle spans whole 64-column atoms, and
//     the 32-byte swizzle's atom is 16 columns.  Q K^T runs 4 k-steps on
//     the first box and a fifth on the second (8-row stride 256 B); each
//     k-step of P V is an n64 product on the first box and an n16 product
//     on the second (8-key stride 256 B), into the accumulator's columns
//     0-63 and 64-79.  Every product still spans only the real columns.
//   * Rows and keys past S come back zero-filled from TMA; the causal
//     mask of the diagonal tile, the only tile that can hold such keys,
//     excludes them for every real row; rows past S are not stored.
// Tried and left out: ping-pong of the two consumer warpgroups on named
// barriers (no gain at S = 2048 on an H100, PERF.md).  Not yet: dynamic
// (LPT) scheduling of the work items, a TMA store of O.

#include <cmath>
#include <cstdint>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMinL;
using flash::kNegInf;
using namespace flash::sm90;

constexpr int kBQ = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 128;          // keys per KV tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kBQ == kBK, "the diagonal tile is the q tile's own index");
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 65536, "register file");

template <int D>
struct Layout {
  using Tile = TileBoxes<D, kBK>;                   // Q, one K or one V tile
  static constexpr int kBoxes = Tile::kFull;        // 128-byte boxes per row
  static constexpr int kBoxBytes = Tile::kBox;      // one box of 128 rows: 16 KB
  static constexpr bool kTail = Tile::kTail;        // D = 80: a 32-byte box of 128 rows,
  static constexpr int kTailOff = Tile::kTailOff;   // 4 KB, after the 64-column box
  static constexpr int kTileBytes = Tile::kBytes;   // what a tile's loads bring
  static constexpr int kQ = 0;                         // Q of slot s at kQ + s * kTileBytes
  static constexpr int kK = 2 * kTileBytes;            // K of stage s at kK + s * kStage
  static constexpr int kStage = 2 * kTileBytes;        // K then V
  static constexpr int kBar = kK + kStages * kStage;
  // q_full[2], q_empty[2], k_full[kStages], v_full[kStages], k_empty[kStages],
  // v_empty[kStages]
  static constexpr int kBars = 4 + 4 * kStages;
  // + 1024: the dynamic buffer is aligned up to the swizzle atom
  static constexpr int kBytes = kBar + 8 * kBars + 1024;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

struct Args {
  __nv_bfloat16* o;
  long long osb, oss, osh;  // element strides of o's (b, s, h)
  int B, S, H, G;
  int n_q_tiles, n_items;  // n_items = n_q_tiles * B * H
  int window;              // <= 0: none
  float scale_log2;        // log2(e) / sqrt(D)
  float* lse;              // (B, H, S) natural-log LSE per row, or null: none
};

// ---- the kernel ------------------------------------------------------------
//
// S and O are m64nN wgmma accumulators (layout: hopper.cuh, pack_a).

// The shared-memory addresses and barriers of one CTA.
template <int D>
struct Smem {
  using L = Layout<D>;
  uint32_t base;
  __device__ uint32_t q(int s) const { return base + L::kQ + s * L::kTileBytes; }
  __device__ uint32_t k(int s) const { return base + L::kK + s * L::kStage; }
  __device__ uint32_t v(int s) const { return k(s) + L::kTileBytes; }
  __device__ uint32_t bar(int i) const { return base + L::kBar + 8u * i; }
  __device__ uint32_t q_full(int s) const { return bar(s); }
  __device__ uint32_t q_empty(int s) const { return bar(2 + s); }
  __device__ uint32_t k_full(int s) const { return bar(4 + s); }
  __device__ uint32_t v_full(int s) const { return bar(4 + kStages + s); }
  __device__ uint32_t k_empty(int s) const { return bar(4 + 2 * kStages + s); }
  __device__ uint32_t v_empty(int s) const { return bar(4 + 3 * kStages + s); }
};

// Issue S = Q K^T for this warpgroup's 64 rows: 4 k-steps a 64-column box,
// 32 bytes apart inside a 128-byte box row; at D = 80 a fifth on the
// 16-column box (q_tail: this warpgroup's rows of it; 8-row stride 256 B).
// Committed as one wgmma group.  The caller pins the accumulators and
// fences first: no instruction but wgmma may write a wgmma's registers
// while its group is in flight.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_rows, uint32_t q_tail,
                                         uint32_t k) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < 4 * L::kBoxes; ++kk) {
    const uint32_t off = (kk / 4) * L::kBoxBytes + (kk % 4) * 32;
    wgmma_ss<kBK>(sc, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k + off, 16, 1024),
                  kk > 0);
  }
  if constexpr (L::kTail)
    wgmma_ss<kBK>(sc, sw32_desc(q_tail, 16, 8 * kTailRowBytes),
                  sw32_desc(k + L::kTailOff, 16, 8 * kTailRowBytes), 1);
  wg_commit();
}

// Issue O += P V: 16 keys per k-step, 2 KB apart; V read MN-major with the
// 64-column boxes 16 KB apart; committed as one wgmma group.  At D = 80 each
// k-step is an n64 product on the 64-column box and an n16 product on the
// 16-column box (16 keys 512 B apart, the 8-key stride 256 B) into the
// accumulator's last 8 floats.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[kBK / 16][4],
                                         uint32_t v) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if constexpr (!L::kTail) {
      wgmma_rs<D>(o, pf[kk], sw128_desc(v + kk * 16 * kRowBytes, L::kBoxBytes, 1024));
    } else {
      wgmma_rs<kBoxCols>(acc_cols<0, kBoxCols>(o), pf[kk],
                         sw128_desc(v + kk * 16 * kRowBytes, L::kBoxBytes, 1024));
      wgmma_rs<kTailCols>(acc_cols<kBoxCols, kTailCols>(o), pf[kk],
                          sw32_desc(v + L::kTailOff + kk * 16 * kTailRowBytes, L::kBoxBytes,
                                    8 * kTailRowBytes));
    }
  }
  wg_commit();
}

// Online softmax of one tile in log2 units, t = s * scale * log2(e): turns
// S into p in place, updates the running max m and this thread's share of
// the sum l, and returns the rescale factors of O in al.  `masked`: the
// causal and window tests, on the diagonal and window-edge tiles only.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], bool masked, int kv0, int tq,
                                             int qpos0, int qpos1, int window, float c,
                                             float (&m)[2], float (&l)[2], float (&al)[2]) {
  float mx[2], mn[2], sum[2] = {0.f, 0.f};
  if (masked) {
    mx[0] = mx[1] = kNegInf;
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int kpos = kv0 + 8 * (e / 4) + 2 * tq + (e & 1);
      const int qpos = (e & 2) ? qpos1 : qpos0;
      const bool on = kpos <= qpos && (window <= 0 || qpos - kpos < window);
      sc[e] = on ? sc[e] * c : kNegInf;
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
  } else {
    mx[0] = sc[0];
    mx[1] = sc[2];
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mn[r] = fmaxf(m[r], masked ? mx[r] : mx[r] * c);
  }
  if (masked) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const float t = sc[e];  // mask-aware exp: a masked p is 0
      sc[e] = t == kNegInf ? 0.f : exp2_approx(t - mn[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += sc[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      sc[e] = exp2_approx(fmaf(sc[e], c, -mn[(e >> 1) & 1]));
      sum[(e >> 1) & 1] += sc[e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    al[r] = exp2_approx(m[r] - mn[r]);
    m[r] = mn[r];
    l[r] = l[r] * al[r] + sum[r];
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&al)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= al[0];
    o[4 * j + 1] *= al[0];
    o[4 * j + 2] *= al[1];
    o[4 * j + 3] *= al[1];
  }
}

// One work item of the persistent grid: a 128-row q tile of one (batch,
// query head), and the KV tiles that meet its band: from the one holding
// the window's first key to the diagonal tile qt.  Items are numbered with
// the q tile slowest and last-first, so the longest causal bands come
// first, and the query head fastest, so the two query heads of a KV group
// run side by side and share its K/V tiles through L2.
struct Item {
  int b, h, q0, j_begin, n_tiles;
};

__device__ __forceinline__ Item item_at(int idx, const Args& a) {
  Item w;
  const int qt = a.n_q_tiles - 1 - idx / (a.B * a.H);
  const int rest = idx % (a.B * a.H);
  w.b = rest / a.H;
  w.h = rest % a.H;
  w.q0 = qt * kBQ;
  w.j_begin = a.window > 0 ? max(0, w.q0 - a.window + 1) / kBK : 0;
  w.n_tiles = qt - w.j_begin + 1;
  return w;
}

// kLse: write the LSE (a.lse); the serve path's instantiation has no LSE
// code at all.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_q1,
                           const __grid_constant__ CUtensorMap tm_k1,
                           const __grid_constant__ CUtensorMap tm_v1, const Args a) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm{(smem_addr(smem_raw) + 1023u) & ~1023u};

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(sm.q_full(s), 1);
      mbar_init(sm.q_empty(s), 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sm.k_full(s), 1);
      mbar_init(sm.v_full(s), 1);
      mbar_init(sm.k_empty(s), 8);
      mbar_init(sm.v_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight, across work
    // items: the next item's Q and first K/V tiles load while the
    // consumers finish the current one.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid == 0) {
      int t = 0;  // KV tiles issued so far: ring slot t % kStages, round t / kStages
      for (int idx = blockIdx.x, n = 0; idx < a.n_items; idx += gridDim.x, ++n) {
        const Item w = item_at(idx, a);
        const int kh = w.h / a.G;
        const int slot = n & 1;
        mbar_wait(sm.q_empty(slot), ((n >> 1) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(sm.q_full(slot), L::kTileBytes);
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load(sm.q(slot) + x * L::kBoxBytes, &tm_q, sm.q_full(slot), x * kBoxCols, w.h,
                   w.q0, w.b);
        if constexpr (L::kTail)
          tma_load(sm.q(slot) + L::kTailOff, &tm_q1, sm.q_full(slot), L::kBoxes * kBoxCols, w.h,
                   w.q0, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++t) {
          const int s = t % kStages;
          const uint32_t free_parity = ((t / kStages) & 1) ^ 1;
          const int kv0 = (w.j_begin + i) * kBK;
          mbar_wait(sm.k_empty(s), free_parity);
          mbar_expect_tx(sm.k_full(s), L::kTileBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(sm.k(s) + x * L::kBoxBytes, &tm_k, sm.k_full(s), x * kBoxCols, kh, kv0,
                     w.b);
          if constexpr (L::kTail)
            tma_load(sm.k(s) + L::kTailOff, &tm_k1, sm.k_full(s), L::kBoxes * kBoxCols, kh, kv0,
                     w.b);
          mbar_wait(sm.v_empty(s), free_parity);
          mbar_expect_tx(sm.v_full(s), L::kTileBytes);
#pragma unroll
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load(sm.v(s) + x * L::kBoxBytes, &tm_v, sm.v_full(s), x * kBoxCols, kh, kv0,
                     w.b);
          if constexpr (L::kTail)
            tma_load(sm.v(s) + L::kTailOff, &tm_v1, sm.v_full(s), L::kBoxes * kBoxCols, kh, kv0,
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
  const int row0 = cw * 64 + warp * 16 + lane / 4;  // tile row of d[4j], d[4j + 1]; + 8: d[4j + 2..3]
  const float c = a.scale_log2;
  const auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  const auto full_parity = [](int t) { return static_cast<uint32_t>((t / kStages) & 1); };

  float o[D / 2];
  float sc[kBK / 2];
  uint32_t pf[kBK / 16][4];
  int t = 0;  // KV tiles consumed so far, as the producer counts them
  for (int idx = blockIdx.x, n = 0; idx < a.n_items; idx += gridDim.x, ++n) {
    const Item w = item_at(idx, a);
    const int slot = n & 1;
    const int qpos0 = w.q0 + row0, qpos1 = qpos0 + 8;
    const uint32_t q_rows = sm.q(slot) + cw * 64 * kRowBytes;
    const uint32_t q_tail = sm.q(slot) + L::kTailOff + cw * 64 * kTailRowBytes;  // D = 80
    const auto masked = [&](int kv0) {  // the diagonal tile and window-edge tiles
      return kv0 + kBK - 1 > w.q0 || (a.window > 0 && kv0 <= w.q0 + kBQ - 1 - a.window);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, in log2 units of the scaled score
    float l[2] = {0.f, 0.f};          // this thread's share of the running sum
    float al[2];
    mbar_wait(sm.q_full(slot), (n >> 1) & 1);

    // Software pipeline: the softmax of tile i runs while the tensor cores
    // do P V of tile i - 1.  Tile 0's S first:
    const int kv_first = w.j_begin * kBK;
    mbar_wait(sm.k_full(t % kStages), full_parity(t));
    pin(sc);
    wg_fence();
    issue_qk<D>(sc, q_rows, q_tail, sm.k(t % kStages));
    wg_wait<0>();
    pin(sc);
    release(sm.k_empty(t % kStages));
    softmax_tile(sc, masked(kv_first), kv_first, tq, qpos0, qpos1, a.window, c, m, l, al);
    pack_a<kBK>(sc, pf);
    for (int i = 1; i < w.n_tiles; ++i) {
      const int tc = t + i, tp = tc - 1;
      const int s = tc % kStages, sp = tp % kStages;
      const int kv0 = (w.j_begin + i) * kBK;
      mbar_wait(sm.k_full(s), full_parity(tc));
      mbar_wait(sm.v_full(sp), full_parity(tp));
      pin(sc);
      pin(o);
      wg_fence();
      issue_qk<D>(sc, q_rows, q_tail, sm.k(s));
      issue_pv<D>(o, pf, sm.v(sp));
      wg_wait<1>();  // S of tile i is done; P V of tile i - 1 may still run
      pin(sc);
      release(sm.k_empty(s));
      softmax_tile(sc, masked(kv0), kv0, tq, qpos0, qpos1, a.window, c, m, l, al);
      wg_wait<0>();
      hold(pf);
      pin(o);
      release(sm.v_empty(sp));
      pack_a<kBK>(sc, pf);
      rescale<D>(o, al);
    }
    const int tl = t + w.n_tiles - 1;
    mbar_wait(sm.v_full(tl % kStages), full_parity(tl));
    pin(o);
    wg_fence();
    issue_pv<D>(o, pf, sm.v(tl % kStages));
    wg_wait<0>();
    hold(pf);
    pin(o);
    release(sm.v_empty(tl % kStages));
    release(sm.q_empty(slot));
    t += w.n_tiles;

    // o = acc / max(l, 1e-30), two bf16 per store; rows past S are
    // dropped.  The producer meanwhile loads the next item's tiles.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], kMinL);
    }
    __nv_bfloat16* out = a.o + w.b * a.osb + w.h * a.osh + 2 * tq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = r ? qpos1 : qpos0;
      if (qpos >= a.S) continue;
      if (kLse && tq == 0)
        a.lse[(static_cast<long long>(w.b) * a.H + w.h) * a.S + qpos] =
            (m[r] + log2f(l[r])) * 0.6931471805599453f;
      __nv_bfloat16* row = out + qpos * a.oss;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

// ---- host side ---------------------------------------------------------------

// One CTA per SM (or per work item, when there are fewer), each walking
// the items blockIdx.x, blockIdx.x + gridDim.x, ...
// tq1, tk1, tv1: the 16-column boxes' maps (D = 80; unread at 64 and 128).
template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& tq1, const CUtensorMap& tk1, const CUtensorMap& tv1, const Args& a,
           cudaStream_t stream) {
  using L = Layout<D>;
  auto kernel =
      a.lse != nullptr ? flash_fwd_wgmma_kernel<D, true> : flash_fwd_wgmma_kernel<D, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();
  if (sms < 0) return -sms;
  kernel<<<a.n_items < sms ? a.n_items : sms, kThreads, L::kBytes, stream>>>(tq, tk, tv, tq1,
                                                                             tk1, tv1, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Same arguments as flash_attention.cu's entry points (element strides of
// the (b, s, h) dimensions of q, k, v and o, the last dimension
// contiguous), and `lse`: a contiguous f32 (B, H, S) buffer for each row's
// natural-log LSE, or null for none.
int flash_attention_wgmma_lse_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int K, int D, int window, long long qsb,
                                   long long qss, long long qsh, long long ksb, long long kss,
                                   long long ksh, long long vsb, long long vss, long long vsh,
                                   long long osb, long long oss, long long osh, void* lse,
                                   void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const long long n_q_tiles = (S + kBQ - 1) / kBQ;
  if (K <= 0 || H % K != 0 || n_q_tiles * B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((D != 64 && D != 80 && D != 128) || !tma_ok(q, B, S, H, qsb, qss, qsh) ||
      !tma_ok(k, B, S, K, ksb, kss, ksh) || !tma_ok(v, B, S, K, vsb, vss, vsh))
    return flash::kErrRoute;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return flash::kErrNoEncoder;
  CUtensorMap tq, tk, tv, tq1, tk1, tv1;
  if (!encode(enc, &tq, q, B, S, H, D, qsb, qss, qsh, kBQ) ||
      !encode(enc, &tk, k, B, S, K, D, ksb, kss, ksh, kBK) ||
      !encode(enc, &tv, v, B, S, K, D, vsb, vss, vsh, kBK))
    return flash::kErrTensorMap;
  if (D == 80) {  // the 16-column boxes at d = 64, under the 32-byte swizzle
    const auto sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
    if (!encode(enc, &tq1, q, B, S, H, D, qsb, qss, qsh, kBQ, kTailCols, sw32) ||
        !encode(enc, &tk1, k, B, S, K, D, ksb, kss, ksh, kBK, kTailCols, sw32) ||
        !encode(enc, &tv1, v, B, S, K, D, vsb, vss, vsh, kBK, kTailCols, sw32))
      return flash::kErrTensorMap;
  } else {
    tq1 = tq;
    tk1 = tk;
    tv1 = tv;
  }
  Args a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.osb = osb;
  a.oss = oss;
  a.osh = osh;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.H = H;
  a.G = H / K;
  a.n_q_tiles = static_cast<int>(n_q_tiles);
  a.n_items = static_cast<int>(n_q_tiles * B * H);
  a.window = window;
  // log2(e) / sqrt(D), rounded once from double
  a.scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128  ? launch<128>(tq, tk, tv, tq1, tk1, tv1, a, st)
         : D == 80 ? launch<80>(tq, tk, tv, tq1, tk1, tv1, a, st)
                   : launch<64>(tq, tk, tv, tq1, tk1, tv1, a, st);
}

// The same without the LSE (the serve path).
int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                               int H, int K, int D, int window, long long qsb, long long qss,
                               long long qsh, long long ksb, long long kss, long long ksh,
                               long long vsb, long long vss, long long vsh, long long osb,
                               long long oss, long long osh, void* stream) {
  return flash_attention_wgmma_lse_bf16(q, k, v, o, B, S, H, K, D, window, qsb, qss, qsh, ksb,
                                        kss, ksh, vsb, vss, vsh, osb, oss, osh, nullptr, stream);
}

// Dynamic shared memory of one CTA of the D instantiation, for reports.
int flash_attention_wgmma_smem_bytes(int D) {
  return D == 128 ? Layout<128>::kBytes
         : D == 80 ? Layout<80>::kBytes
         : D == 64 ? Layout<64>::kBytes
                   : 0;
}

}  // extern "C"
