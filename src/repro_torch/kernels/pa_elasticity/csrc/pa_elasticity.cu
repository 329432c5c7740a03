// Fused sum-factorized PAop elasticity apply, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C interface and ctypes.
//
// Replaces: src/repro/kernels/pa_elasticity/pa_elasticity.py::_kernel
// (launched by pa_elasticity_pallas, wrapped by ops.py::pa_elasticity).
// It computes what that kernel computes, y_e = PAop(x_e) per element:
//   1. B/G contractions along x, y and z give each displacement
//      component's reference gradient;
//   2. the mesh-constant J^{-1} maps it to the physical gradient, folded
//      into 6 weighted Voigt stresses (lam_w * div + 2 mu_w * eps);
//   3. the rows of sigma . J^{-T} are pulled back;
//   4. transposed contractions give y_e.
// It does not carry over the TPU blocking (element-last layout, padding to
// whole element blocks, the VMEM budget): the layout is the framework's
// element-first one, x/y (NE, 3, D, D, D), lam_w/mu_w (NE, Q, Q, Q), B/G
// (Q, D), J^{-1} (3, 3).
//
// What bounds it on this card.  Per element it must read x, lam_w, mu_w
// and write y, (6 D^3 + 2 Q^3) words, against paop_flops_per_elem(p)
// operations.  At p = 4 in f64, NE = 32,768: 303 MB, 0.0925 ms at
// 3.35 TB/s (the bound); 3.50 GFLOP, 0.104 ms on the f64 FMA pipes
// (33.5 TFLOP/s, 64 FMA/clk/SM) this kernel runs on.  The sweeps stage
// every intermediate in shared memory, which gives an SM 128 B/clk: 16
// doubles against 64 FMA/clk.  The first port (pa_elasticity_baseline.cu)
// gave each thread one output point and read both the operand and the
// B/G entry from shared memory for every FMA (~1.5 shared words per FMA),
// on blocks of 72 threads that left whole lanes idle.
//
// The design:
//   * Blocks of kThreads (whole warps) hold kElems whole elements, and
//     every quadrature column of an element has its owner threads.
//   * Pencil sweeps.  Each sweep is a loop over its pencils (one line of
//     an element along the contracted axis), a pencil per thread: it reads
//     its inputs from shared memory once into registers and produces all
//     its outputs, or streams its inputs into register sums, whichever
//     needs fewer registers.  The B/G index is a function of the unrolled
//     loop counters alone, so every lane reads the same table word (a
//     broadcast), and a sweep takes the three displacement components at
//     once, so each table word serves three FMAs.  Intermediate rows are
//     padded against bank conflicts.
//   * The column owner keeps the six Voigt channels in registers through
//     the Z sweep, the pointwise stress and the Z^T sweep.  From p = 7 on
//     two neighbouring lanes share a column, each holding half of its
//     points along z; the Z^T partial sums meet through a shuffle.
//   * x is copied once, contiguously, with cp.async (16 bytes where the
//     source allows) into shared memory at a shift that makes the source
//     and the copy agree modulo 16 bytes; y is assembled in x's place and
//     written out the same way.  The owners read lam_w/mu_w into
//     registers at the pointwise stress.
//   * __launch_bounds__ caps the registers so that kMinBlocks blocks fit
//     on an SM (ptxas -v reports the spills; pa_elasticity_config_*
//     reports blocks per SM and shared bytes).
// Measured (PERF.md): neither the shared-memory traffic nor the FMA issue
// is saturated at p = 4 (each is about half busy by the count above), so
// latency between the short, synchronised sweeps sets the pace; tune.py
// times the launch-configuration choices.
//
// Instantiated for p = 1..8 (D = p + 1, Q = p + 2) in float64 and float32.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Elements a block holds, by D = 2..9 and threads a quadrature column:
// about 128 threads or fewer, and shared memory for 2-5 blocks an SM in f64.
constexpr int elems_for(int d, int split) {
  return split == 2 ? (d == 2 ? 7 : d == 3 ? 4 : d <= 5 ? 2 : 1)
                    : (d == 2 ? 14 : d == 3 ? 8 : d <= 5 ? 3 : 1);
}

// Launch shape and shared-memory layout per (T, D); sizes in words of T.
template <typename T, int D>
struct Config {
  static constexpr int Q = D + 1;
  // Threads a quadrature column: each owns Qh of its Q points along z and
  // holds 6 Qh Voigt values.  Two (neighbouring lanes) from p = 7 on, where
  // 6 Q values crowd out the sweeps' registers; one below, where the
  // second thread's shuffles and duplicate loads cost more than the
  // registers it frees (tune.py: p = 2, 4, 6 and 8 timed).  Threads in
  // all: whole warps.
  static constexpr int kSplit = D >= 8 ? 2 : 1;
  static constexpr int Qh = (Q + kSplit - 1) / kSplit;
  static constexpr int kElems = elems_for(D, kSplit);
  static constexpr int kThreads = round_up(kElems * Q * Q * kSplit, 32);
  // Displacement components a sweep takes at once: 3, so that every table
  // word a lane reads serves three FMAs; 1 (one component at a time) for
  // f64 at p = 8, where three components' intermediates would leave room
  // for one block an SM.
  static constexpr int kGroup = sizeof(T) == 8 && D == 9 ? 1 : 3;
  static constexpr int kAlign = 16 / static_cast<int>(sizeof(T));
  // U/V rows along qx: an odd stride, so a warp's pencils hit distinct
  // banks.  W's z stride is congruent to Q modulo the words one shared
  // wavefront spreads over (16 doubles, 32 floats), so the lanes of a Y
  // sweep (z, qx) and of a column owner (qy, qx) both see it as
  // contiguous.
  static constexpr int kBankWords = 128 / static_cast<int>(sizeof(T));
  static constexpr int Qp = Q | 1;
  static constexpr int Sz = Q * Q + ((Q - Q * Q) % kBankWords + kBankWords) % kBankWords;
  static constexpr int kUElem = kGroup * D * D * Qp;  // U/V: [g][y][z][qx]
  static constexpr int kWElem = 3 * kGroup * D * Sz;  // W: [g][m][z][qy][qx]
  static constexpr int kT = round_up(Q * D, kAlign);  // B, then G
  static constexpr int kJ = round_up(9, kAlign);
  // x in, y out, with one 16-byte chunk of slack for the shift.
  static constexpr int kX = round_up(kElems * 3 * D * D * D, kAlign) + kAlign;
  static constexpr int kU = round_up(kElems * kUElem, kAlign);
  static constexpr int kW = round_up(kElems * kWElem, kAlign);
  static constexpr int kWords = 2 * kT + kJ + kX + 2 * kU + kW;
  static constexpr int kBytes = static_cast<int>(sizeof(T)) * kWords;
  // Blocks per SM the register cap is set for: as many as the SM's
  // 232,448 B of shared memory hold (1 KB of it reserved per block), but no
  // fewer registers a thread than an owner needs beside a sweep's values
  // (6 Qh Voigt values): in f64 168 with one thread a column, 128 with
  // two; 96 in f32.
  static constexpr int kSmemBlocks = 232448 / (kBytes + 1024);
  static constexpr int kRegBlocks =
      65536 / (kThreads * (sizeof(T) == 8 ? (kSplit == 1 ? 168 : 128) : 96));
  static constexpr int kMinBlocks = kSmemBlocks < kRegBlocks ? kSmemBlocks : kRegBlocks;
};

// Voigt slot of the symmetric pair (a, b): [00, 11, 22, 01, 02, 12].
__host__ __device__ constexpr int voigt(int a, int b) {
  return a == b ? a : 2 + a + b;
}

// Words of T by which p lies past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int shift_words(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n words from global src to shared dst, which agree modulo 16 bytes:
// word copies up to the first 16-byte boundary, 16-byte copies, a word tail.
template <typename T, int NT>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int n, int tid) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (V - shift_words(src)) % V);
  const int body = (n - head) / V;
  for (int i = tid; i < head; i += NT) cp_async<sizeof(T)>(dst + i, src + i);
  for (int i = tid; i < body; i += NT) {
    cp_async<16>(dst + head + i * V, src + head + i * V);
  }
  for (int i = head + body * V + tid; i < n; i += NT) {
    cp_async<sizeof(T)>(dst + i, src + i);
  }
}

// n words from shared src to global dst: 16-byte stores where the two
// agree modulo 16 bytes, word stores otherwise.
template <typename T, int NT>
__device__ __forceinline__ void copy_out(T* dst, const T* src, int n, int tid) {
  constexpr int V = 16 / sizeof(T);
  if (shift_words(dst) != shift_words(src)) {
    for (int i = tid; i < n; i += NT) dst[i] = src[i];
    return;
  }
  const int head = min(n, (V - shift_words(src)) % V);
  const int body = (n - head) / V;
  for (int i = tid; i < head; i += NT) dst[i] = src[i];
  for (int i = tid; i < body; i += NT) {
    reinterpret_cast<int4*>(dst + head)[i] =
        reinterpret_cast<const int4*>(src + head)[i];
  }
  for (int i = head + body * V + tid; i < n; i += NT) dst[i] = src[i];
}

template <typename T, int D>
__global__ void __launch_bounds__(Config<T, D>::kThreads, Config<T, D>::kMinBlocks)
pa_elasticity_kernel(const T* __restrict__ x, const T* __restrict__ lam,
                     const T* __restrict__ mu, const T* __restrict__ jinv,
                     const T* __restrict__ Bg, const T* __restrict__ Gg,
                     T* __restrict__ y, long long ne) {
  using C = Config<T, D>;
  constexpr int Q = C::Q, NT = C::kThreads, NB = C::kElems, CG = C::kGroup;
  constexpr int S = C::kSplit, Qh = C::Qh;
  constexpr int D3 = D * D * D, Q3 = Q * Q * Q, QQ = Q * Q, DD = D * D;
  constexpr int Qp = C::Qp, Sz = C::Sz, SU = C::kUElem, SW = C::kWElem;
  constexpr int DSz = D * Sz;   // W's channel stride
  constexpr int YS = D * Qp;    // U/V's y stride
  constexpr int US = DD * Qp;   // U/V's component stride

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sB = reinterpret_cast<T*>(smem_raw);  // [Q][D]
  T* sG = sB + C::kT;                      // [Q][D]
  T* sJ = sG + C::kT;                      // [3][3]
  T* sXr = sJ + C::kJ;
  T* sU = sXr + C::kX;  // [NB][CG][y][z][qx]
  T* sV = sU + C::kU;   // [NB][CG][y][z][qx]
  T* sW = sV + C::kU;   // [NB][CG][3][z][qy][qx]

  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * NB;
  const int nb = static_cast<int>(ne - e0 < NB ? ne - e0 : NB);  // ragged tail

  // ---- stage x with cp.async, and the tables.
  const T* xg = x + e0 * 3 * D3;
  T* sX = sXr + shift_words(xg);  // [NB][3][z][y][x]: x, then y
  copy_in<T, NT>(sX, xg, nb * 3 * D3, tid);
  cp_async_commit();
  for (int i = tid; i < Q * D; i += NT) {
    sB[i] = Bg[i];
    sG[i] = Gg[i];
  }
  if (tid < 9) sJ[tid] = jinv[tid];

  // The owners of a column: element ce, column col = qy * Q + qx, part h of
  // the points along z, qz = qz0 + k for k < Qh (and qz < Q).
  const int ce = tid / (QQ * S), col = tid % (QQ * S) / S, h = tid % S;
  const int qz0 = h * Qh;
  const bool owner = tid < nb * QQ * S;
  cp_async_wait<0>();
  __syncthreads();

  // ---- forward, CG displacement components c = c0 + g at a time.  acc
  // holds the owner's running Voigt channels at its Qh points along z:
  // slots 0..2 the diagonal gradients d_c u_c, slots 3..5 the symmetrized
  // sums d_k u_j + d_j u_k.
  T acc[6][Qh];
#pragma unroll
  for (int c0 = 0; c0 < 3; c0 += CG) {
    // X sweep: pencil (e, y, z) along x -> U (B) and V (G) at (y, z, qx).
    for (int w = tid; w < nb * DD; w += NT) {
      const int e = w / DD, r = w % DD, iy = r / D, iz = r % D;
      const T* px = sX + e * 3 * D3 + c0 * D3 + (iz * D + iy) * D;
      T xv[CG][D];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int ix = 0; ix < D; ++ix) xv[g][ix] = px[g * D3 + ix];
      }
      T* pu = sU + e * SU + r * Qp;
      T* pv = sV + e * SU + r * Qp;
#pragma unroll
      for (int qx = 0; qx < Q; ++qx) {
        T u[CG], v[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g) u[g] = v[g] = 0;
#pragma unroll
        for (int ix = 0; ix < D; ++ix) {
          const T b = sB[qx * D + ix], gd = sG[qx * D + ix];
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            u[g] += b * xv[g][ix];
            v[g] += gd * xv[g][ix];
          }
        }
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          pu[g * US + qx] = u[g];
          pv[g * US + qx] = v[g];
        }
      }
    }
    __syncthreads();
    // Y sweep: pencil (e, z, qx) along y -> W0, W1, W2 at (z, qy, qx).
    for (int w = tid; w < nb * D * Q; w += NT) {
      const int e = w / (D * Q), r = w % (D * Q), iz = r / Q, qx = r % Q;
      const T* pu = sU + e * SU + iz * Qp + qx;
      const T* pv = sV + e * SU + iz * Qp + qx;
      T uu[CG][D], vv[CG][D];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int iy = 0; iy < D; ++iy) {
          uu[g][iy] = pu[g * US + iy * YS];
          vv[g][iy] = pv[g * US + iy * YS];
        }
      }
      T* pw = sW + e * SW + iz * Sz + qx;
#pragma unroll
      for (int qy = 0; qy < Q; ++qy) {
        T a[CG], b[CG], s[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g) a[g] = b[g] = s[g] = 0;
#pragma unroll
        for (int iy = 0; iy < D; ++iy) {
          const T bt = sB[qy * D + iy], gt = sG[qy * D + iy];
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            a[g] += bt * vv[g][iy];  // d_xi:   G in x, B in y
            b[g] += gt * uu[g][iy];  // d_eta:  B in x, G in y
            s[g] += bt * uu[g][iy];  // d_zeta: B in x, B in y
          }
        }
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          pw[3 * g * DSz + qy * Q] = a[g];
          pw[(3 * g + 1) * DSz + qy * Q] = b[g];
          pw[(3 * g + 2) * DSz + qy * Q] = s[g];
        }
      }
    }
    __syncthreads();
    // Z sweep on the owner's column and part of z, one reference direction
    // m at a time (B along z for m = 0, 1; G for m = 2), each folded into
    // the accumulators as d_j u_c += ghat[c, m] Jinv[m, j].  The two owners
    // of a column read the same W words (one wavefront) and different
    // table rows.  (With CG = 1 the next X sweep writes only U/V, and the
    // sync after it orders these W reads before the next Y sweep rewrites
    // W.)
    if (owner) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const T* tab = (m == 2 ? sG : sB) + qz0 * D;
        const T* pw = sW + ce * SW + m * DSz + col;
        T wm[CG][D];
#pragma unroll
        for (int g = 0; g < CG; ++g) {
#pragma unroll
          for (int iz = 0; iz < D; ++iz) wm[g][iz] = pw[3 * g * DSz + iz * Sz];
        }
        const T jm[3] = {sJ[3 * m], sJ[3 * m + 1], sJ[3 * m + 2]};
#pragma unroll
        for (int k = 0; k < Qh; ++k) {
          if (Q % S != 0 && qz0 + k >= Q) break;
          T gq[CG];
#pragma unroll
          for (int g = 0; g < CG; ++g) gq[g] = 0;
#pragma unroll
          for (int iz = 0; iz < D; ++iz) {
            const T t = tab[k * D + iz];
#pragma unroll
            for (int g = 0; g < CG; ++g) gq[g] += t * wm[g][iz];
          }
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            const int c = c0 + g;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              if (m == 0 && (j == c || c < j)) {
                acc[voigt(c, j)][k] = gq[g] * jm[j];  // first contribution
              } else {
                acc[voigt(c, j)][k] += gq[g] * jm[j];
              }
            }
          }
        }
      }
    }
  }

  // ---- pointwise weighted Voigt stress, in place in the accumulators.
  // The owner reads its column of lam_w/mu_w straight into registers here
  // (loaded before the sweeps, they cost registers that the sweeps need
  // more: tune.py).
  if (owner) {
    const T* lq = lam + (e0 + ce) * Q3 + col;
    const T* mq = mu + (e0 + ce) * Q3 + col;
#pragma unroll
    for (int k = 0; k < Qh; ++k) {
      if (Q % S != 0 && qz0 + k >= Q) break;
      const T lw = lq[(qz0 + k) * QQ], mw = mq[(qz0 + k) * QQ];
      const T ld = lw * (acc[0][k] + acc[1][k] + acc[2][k]);
      const T two_mu = T(2) * mw;
      acc[0][k] = ld + two_mu * acc[0][k];
      acc[1][k] = ld + two_mu * acc[1][k];
      acc[2][k] = ld + two_mu * acc[2][k];
      acc[3][k] = mw * acc[3][k];
      acc[4][k] = mw * acc[4][k];
      acc[5][k] = mw * acc[5][k];
    }
  }

  // ---- backward, CG output components c = c0 + g at a time.
#pragma unroll
  for (int c0 = 0; c0 < 3; c0 += CG) {
    // Pull-back rows q_m = sum_j sigma[c, j] Jinv[m, j] and the Z^T sweep
    // on the owner's column (G along z for m = 2, B otherwise), one m at a
    // time, into W: each owner sums over its part of z, the two parts are
    // added across the neighbouring lanes (every lane of the warp takes part
    // in the shuffle), and each owner writes half of the result.  The
    // owners wrote and read only their own column of W since the last sync,
    // and (CG = 1) the previous component's Y^T reads of W finished before
    // the sync that preceded its X^T sweep.
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const T* tab = (m == 2 ? sG : sB) + qz0 * D;
      const T j0 = sJ[3 * m], j1 = sJ[3 * m + 1], j2 = sJ[3 * m + 2];
      T t[CG][D];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int iz = 0; iz < D; ++iz) t[g][iz] = 0;
      }
      if (owner) {
#pragma unroll
        for (int k = 0; k < Qh; ++k) {
          if (Q % S != 0 && qz0 + k >= Q) break;
          T q[CG];
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            const int c = c0 + g;
            q[g] = acc[voigt(c, 0)][k] * j0 + acc[voigt(c, 1)][k] * j1 +
                   acc[voigt(c, 2)][k] * j2;
          }
#pragma unroll
          for (int iz = 0; iz < D; ++iz) {
            const T tz = tab[k * D + iz];
#pragma unroll
            for (int g = 0; g < CG; ++g) t[g][iz] += tz * q[g];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int iz = 0; iz < D; ++iz) {
#pragma unroll
          for (int lane = 1; lane < S; lane *= 2) {
            t[g][iz] += __shfl_xor_sync(0xffffffffu, t[g][iz], lane);
          }
        }
      }
      if (owner) {
        T* pw = sW + ce * SW + m * DSz + col;
#pragma unroll
        for (int g = 0; g < CG; ++g) {
#pragma unroll
          for (int iz = 0; iz < D; ++iz) {
            if (iz % S == h) pw[3 * g * DSz + iz * Sz] = t[g][iz];
          }
        }
      }
    }
    __syncthreads();
    // Y^T sweep: pencil (e, z, qx) along qy, streamed into register sums
    // -> U (G along x follows) and V (B along x follows) at (y, z, qx).
    // m = 0 takes B along y; m = 1 G and m = 2 B along y share V.
    for (int w = tid; w < nb * D * Q; w += NT) {
      const int e = w / (D * Q), r = w % (D * Q), iz = r / Q, qx = r % Q;
      const T* pw = sW + e * SW + iz * Sz + qx;
      T wg[CG][D], wb[CG][D];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int iy = 0; iy < D; ++iy) wg[g][iy] = wb[g][iy] = 0;
      }
#pragma unroll
      for (int qy = 0; qy < Q; ++qy) {
        T a[CG], b[CG], s[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          a[g] = pw[3 * g * DSz + qy * Q];
          b[g] = pw[(3 * g + 1) * DSz + qy * Q];
          s[g] = pw[(3 * g + 2) * DSz + qy * Q];
        }
#pragma unroll
        for (int iy = 0; iy < D; ++iy) {
          const T bt = sB[qy * D + iy], gt = sG[qy * D + iy];
#pragma unroll
          for (int g = 0; g < CG; ++g) {
            wg[g][iy] += bt * a[g];
            wb[g][iy] += gt * b[g] + bt * s[g];
          }
        }
      }
      T* pu = sU + e * SU + iz * Qp + qx;
      T* pv = sV + e * SU + iz * Qp + qx;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int iy = 0; iy < D; ++iy) {
          pu[g * US + iy * YS] = wg[g][iy];
          pv[g * US + iy * YS] = wb[g][iy];
        }
      }
    }
    __syncthreads();
    // X^T sweep: pencil (e, y, z) along qx, streamed into register sums,
    // written into components c0 .. c0 + CG - 1 of y in x's place.  (With
    // CG = 1 the next component's Y^T writes U/V only after the sync that
    // follows its Z^T sweep.)
    for (int w = tid; w < nb * DD; w += NT) {
      const int e = w / DD, r = w % DD, iy = r / D, iz = r % D;
      const T* pu = sU + e * SU + r * Qp;
      const T* pv = sV + e * SU + r * Qp;
      T out[CG][D];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int ix = 0; ix < D; ++ix) out[g][ix] = 0;
      }
#pragma unroll
      for (int qx = 0; qx < Q; ++qx) {
        T gu[CG], bv[CG];
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          gu[g] = pu[g * US + qx];
          bv[g] = pv[g * US + qx];
        }
#pragma unroll
        for (int ix = 0; ix < D; ++ix) {
          const T gt = sG[qx * D + ix], bt = sB[qx * D + ix];
#pragma unroll
          for (int g = 0; g < CG; ++g) out[g][ix] += gt * gu[g] + bt * bv[g];
        }
      }
      T* py = sX + e * 3 * D3 + c0 * D3 + (iz * D + iy) * D;
#pragma unroll
      for (int g = 0; g < CG; ++g) {
#pragma unroll
        for (int ix = 0; ix < D; ++ix) py[g * D3 + ix] = out[g][ix];
      }
    }
  }
  __syncthreads();
  copy_out<T, NT>(y + e0 * 3 * D3, sX, nb * 3 * D3, tid);
}

template <typename T, int D>
cudaError_t allow_smem() {
  using C = Config<T, D>;
  if (C::kBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(pa_elasticity_kernel<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(C::kBytes));
}

template <typename T, int D>
cudaError_t launch(const void* x, const void* lam, const void* mu,
                   const void* jinv, const void* B, const void* G, void* y,
                   long long ne, cudaStream_t stream) {
  using C = Config<T, D>;
  const cudaError_t err = allow_smem<T, D>();
  if (err != cudaSuccess) return err;
  const long long blocks = (ne + C::kElems - 1) / C::kElems;
  if (blocks == 0) return cudaSuccess;
  pa_elasticity_kernel<T, D><<<static_cast<unsigned>(blocks), C::kThreads,
                               C::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lam),
      static_cast<const T*>(mu), static_cast<const T*>(jinv),
      static_cast<const T*>(B), static_cast<const T*>(G),
      static_cast<T*>(y), ne);
  return cudaGetLastError();
}

// The launch shape of one instantiation and how many of its blocks an SM
// of the current card holds at once.
template <typename T, int D>
cudaError_t config(int* threads, int* elems, int* smem_bytes, int* blocks_per_sm) {
  using C = Config<T, D>;
  const cudaError_t err = allow_smem<T, D>();
  if (err != cudaSuccess) return err;
  *threads = C::kThreads;
  *elems = C::kElems;
  *smem_bytes = C::kBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pa_elasticity_kernel<T, D>, C::kThreads, C::kBytes);
}

// f(std::integral_constant<int, D>) for D = d1d in 2..9.
template <typename F>
cudaError_t by_order(int d1d, F&& f) {
  switch (d1d) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 9: return f(std::integral_constant<int, 9>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* x, const void* lam, const void* mu, const void* jinv,
             const void* B, const void* G, void* y, long long ne, int d1d,
             int q1d, void* stream) {
  if (q1d != d1d + 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_order(d1d, [&](auto d) {
    return launch<T, decltype(d)::value>(x, lam, mu, jinv, B, G, y, ne, s);
  }));
}

template <typename T>
int dispatch_config(int d1d, int* threads, int* elems, int* smem_bytes,
                    int* blocks_per_sm) {
  return static_cast<int>(by_order(d1d, [&](auto d) {
    return config<T, decltype(d)::value>(threads, elems, smem_bytes, blocks_per_sm);
  }));
}

}  // namespace

extern "C" {

int pa_elasticity_f64(const void* x, const void* lam, const void* mu,
                      const void* jinv, const void* B, const void* G, void* y,
                      long long ne, int d1d, int q1d, void* stream) {
  return dispatch<double>(x, lam, mu, jinv, B, G, y, ne, d1d, q1d, stream);
}

int pa_elasticity_f32(const void* x, const void* lam, const void* mu,
                      const void* jinv, const void* B, const void* G, void* y,
                      long long ne, int d1d, int q1d, void* stream) {
  return dispatch<float>(x, lam, mu, jinv, B, G, y, ne, d1d, q1d, stream);
}

int pa_elasticity_config_f64(int d1d, int* threads, int* elems, int* smem_bytes,
                             int* blocks_per_sm) {
  return dispatch_config<double>(d1d, threads, elems, smem_bytes, blocks_per_sm);
}

int pa_elasticity_config_f32(int d1d, int* threads, int* elems, int* smem_bytes,
                             int* blocks_per_sm) {
  return dispatch_config<float>(d1d, threads, elems, smem_bytes, blocks_per_sm);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
