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
// It does not carry over the TPU blocking: the element-last layout, the
// padding to whole element blocks and the VMEM budget exist for the TPU's
// 128-wide lanes.  The layout here is the framework's element-first one:
// x/y (NE, 3, D, D, D), lam_w/mu_w (NE, Q, Q, Q), B/G (Q, D), J^{-1} (3, 3).
//
// What bounds it on this card: per element it must read x, lam_w, mu_w and
// write y, (6 D^3 + 2 Q^3) words, against paop_flops_per_elem(p)
// operations.  At p = 4 in f64 that is 9.5 KB for 107 kFLOP, about 11
// FLOP/byte.  Against the H100 SXM data-sheet peaks (3.35 TB/s, and
// 67 TFLOP/s in f64 with the tensor cores: 20 FLOP/byte) the bytes bound
// it; on the f64 FMA units this kernel uses (34 TFLOP/s: 10 FLOP/byte) the
// two are about even.  So the
// design touches device memory once per word: one thread block owns whole
// elements; x is staged once in shared memory; every intermediate (the two
// X-sweep channels, the three Y-sweep channels, the transposed sweeps)
// lives in shared memory; the six Voigt channels live in registers; lam_w
// and mu_w are read once, at the point where they are used; y is written
// once.  The component-sliced order of the TPU kernel is kept: the forward
// pass walks one displacement component at a time and folds its gradient
// into the Voigt accumulators, the backward pass emits one output
// component at a time.
//
// Threads: a Q x Q tile per element, thread (tx, ty) owns the quadrature
// column (qx, qy) = (tx, ty) and walks the z-slices; at low p a block holds
// several elements (blockDim.z) so that it has at least 64 threads.  B and
// G sit in shared memory.  At p = 8 in f64 a block needs more than the
// 48 KB of static shared memory, so the launch raises the dynamic limit
// with cudaFuncSetAttribute first.
//
// Instantiated for p = 1..8 (D = p + 1, Q = p + 2) in float64 and float32.

#include <cuda_runtime.h>

namespace {

constexpr int kMinThreadsPerBlock = 64;

template <int Q>
struct Tile {
  static constexpr int kElems =
      (kMinThreadsPerBlock + Q * Q - 1) / (Q * Q);  // elements per block
  static constexpr int kThreads = Q * Q * kElems;
};

template <typename T, int D, int Q>
struct Smem {
  static constexpr int kTables = 2 * Q * D;  // B, G
  // x (3 components), X-sweep (2 channels), Y-sweep (3 channels)
  static constexpr int kPerElem = 3 * D * D * D + 2 * D * D * Q + 3 * D * Q * Q;
  static constexpr size_t kBytes =
      sizeof(T) * (kTables + static_cast<size_t>(Tile<Q>::kElems) * kPerElem);
};

// Voigt slot of the symmetric pair (a, b): [00, 11, 22, 01, 02, 12].
__host__ __device__ constexpr int voigt(int a, int b) {
  return a == b ? a : 2 + a + b;
}

template <typename T, int D, int Q>
__global__ void __launch_bounds__(Tile<Q>::kThreads)
pa_elasticity_kernel(const T* __restrict__ x, const T* __restrict__ lam,
                     const T* __restrict__ mu, const T* __restrict__ jinv,
                     const T* __restrict__ Bg, const T* __restrict__ Gg,
                     T* __restrict__ y, long long ne) {
  constexpr int NB = Tile<Q>::kElems;
  constexpr int NT = Tile<Q>::kThreads;
  constexpr int D3 = D * D * D;
  constexpr int Q3 = Q * Q * Q;
  constexpr int QQ = Q * Q;
  constexpr int DQQ = D * Q * Q;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  T* sB = reinterpret_cast<T*>(smem_raw);  // [Q][D]
  T* sG = sB + Q * D;                      // [Q][D]
  T* sX = sG + Q * D + tz * Smem<T, D, Q>::kPerElem;  // [3][D][D][D]
  T* sU = sX + 3 * D3;                     // [D][D][Q]
  T* sV = sU + D * D * Q;                  // [D][D][Q]
  T* sW = sV + D * D * Q;                  // [3][D][Q][Q]

  const int tid = tx + Q * (ty + Q * tz);
  const int ltid = tx + Q * ty;
  const long long e = static_cast<long long>(blockIdx.x) * NB + tz;
  const bool valid = e < ne;  // the last block may hold fewer elements

  for (int i = tid; i < Q * D; i += NT) {
    sB[i] = Bg[i];
    sG[i] = Gg[i];
  }
  T J[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) J[i] = jinv[i];
  if (valid) {
    const T* xe = x + e * 3 * D3;
    for (int i = ltid; i < 3 * D3; i += QQ) sX[i] = xe[i];
  } else {
    for (int i = ltid; i < 3 * D3; i += QQ) sX[i] = T(0);
  }
  __syncthreads();

  // ---- forward, one displacement component c at a time.  acc holds the
  // running Voigt channels at this thread's (qy, qx) column for every qz:
  // slots 0..2 the diagonal gradients d_c u_c, slots 3..5 the symmetrized
  // sums d_k u_j + d_j u_k.
  T acc[6][Q];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const T* xc = sX + c * D3;
    // X sweep: (z, y, x) -> (z, y, qx), threads (qx, y) = (tx, ty).
    if (ty < D) {
      for (int iz = 0; iz < D; ++iz) {
        T u = 0, v = 0;
#pragma unroll
        for (int ix = 0; ix < D; ++ix) {
          const T xv = xc[(iz * D + ty) * D + ix];
          u += sB[tx * D + ix] * xv;
          v += sG[tx * D + ix] * xv;
        }
        sU[(iz * D + ty) * Q + tx] = u;
        sV[(iz * D + ty) * Q + tx] = v;
      }
    }
    __syncthreads();
    // Y sweep: (z, y, qx) -> (z, qy, qx), threads (qx, qy) = (tx, ty).
    for (int iz = 0; iz < D; ++iz) {
      T a = 0, b = 0, w = 0;
#pragma unroll
      for (int iy = 0; iy < D; ++iy) {
        const T uu = sU[(iz * D + iy) * Q + tx];
        const T vv = sV[(iz * D + iy) * Q + tx];
        a += sB[ty * D + iy] * vv;  // d_xi:   G in x, B in y
        b += sG[ty * D + iy] * uu;  // d_eta:  B in x, G in y
        w += sB[ty * D + iy] * uu;  // d_zeta: B in x, B in y
      }
      const int o = iz * QQ + ty * Q + tx;
      sW[o] = a;
      sW[DQQ + o] = b;
      sW[2 * DQQ + o] = w;
    }
    __syncthreads();
    // Z sweep on this thread's column, then the physical gradient
    // d_j u_c = sum_m ghat[c, m] Jinv[m, j], folded into the accumulators.
    // (The next X sweep writes only sU/sV, and the sync after it orders
    // these sW reads before the next Y sweep rewrites sW.)
#pragma unroll
    for (int qz = 0; qz < Q; ++qz) {
      T g0 = 0, g1 = 0, g2 = 0;
#pragma unroll
      for (int iz = 0; iz < D; ++iz) {
        const int o = iz * QQ + ty * Q + tx;
        g0 += sB[qz * D + iz] * sW[o];
        g1 += sB[qz * D + iz] * sW[DQQ + o];
        g2 += sG[qz * D + iz] * sW[2 * DQQ + o];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T grad = g0 * J[j] + g1 * J[3 + j] + g2 * J[6 + j];
        if (j == c || c < j) {
          acc[voigt(c, j)][qz] = grad;  // first contribution to the slot
        } else {
          acc[voigt(c, j)][qz] += grad;
        }
      }
    }
  }

  // ---- pointwise weighted Voigt stress, in place in the accumulators.
#pragma unroll
  for (int qz = 0; qz < Q; ++qz) {
    T lw = 0, mw = 0;
    if (valid) {
      const long long qo = e * Q3 + (qz * Q + ty) * Q + tx;
      lw = lam[qo];
      mw = mu[qo];
    }
    const T ld = lw * (acc[0][qz] + acc[1][qz] + acc[2][qz]);
    const T two_mu = T(2) * mw;
    acc[0][qz] = ld + two_mu * acc[0][qz];
    acc[1][qz] = ld + two_mu * acc[1][qz];
    acc[2][qz] = ld + two_mu * acc[2][qz];
    acc[3][qz] = mw * acc[3][qz];
    acc[4][qz] = mw * acc[4][qz];
    acc[5][qz] = mw * acc[5][qz];
  }
  __syncthreads();  // the last Z sweep's sW reads end before Z^T writes sW

  // ---- backward, one output component c at a time.
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // Pull-back rows q_m = sum_j sigma[c, j] Jinv[m, j] and the Z^T sweep
    // on this thread's column: G along z for m = 2, B otherwise.
    T t0[D], t1[D], t2[D];
#pragma unroll
    for (int iz = 0; iz < D; ++iz) t0[iz] = t1[iz] = t2[iz] = 0;
#pragma unroll
    for (int qz = 0; qz < Q; ++qz) {
      const T s0 = acc[voigt(c, 0)][qz];
      const T s1 = acc[voigt(c, 1)][qz];
      const T s2 = acc[voigt(c, 2)][qz];
      const T q0 = s0 * J[0] + s1 * J[1] + s2 * J[2];
      const T q1 = s0 * J[3] + s1 * J[4] + s2 * J[5];
      const T q2 = s0 * J[6] + s1 * J[7] + s2 * J[8];
#pragma unroll
      for (int iz = 0; iz < D; ++iz) {
        t0[iz] += sB[qz * D + iz] * q0;
        t1[iz] += sB[qz * D + iz] * q1;
        t2[iz] += sG[qz * D + iz] * q2;
      }
    }
    // (The previous component's Y^T reads of sW finished before the sync
    // that preceded its X^T sweep.)
#pragma unroll
    for (int iz = 0; iz < D; ++iz) {
      const int o = iz * QQ + ty * Q + tx;
      sW[o] = t0[iz];
      sW[DQQ + o] = t1[iz];
      sW[2 * DQQ + o] = t2[iz];
    }
    __syncthreads();
    // Y^T sweep: (z, qy, qx) -> (z, y, qx), threads (qx, y) = (tx, ty).
    // m = 0 takes B along y and G along x; m = 1 takes G along y and
    // m = 2 B along y, both B along x, so they share one channel.
    if (ty < D) {
      for (int iz = 0; iz < D; ++iz) {
        T wg = 0, wb = 0;
#pragma unroll
        for (int qy = 0; qy < Q; ++qy) {
          const int o = iz * QQ + qy * Q + tx;
          wg += sB[qy * D + ty] * sW[o];
          wb += sG[qy * D + ty] * sW[DQQ + o] + sB[qy * D + ty] * sW[2 * DQQ + o];
        }
        sU[(iz * D + ty) * Q + tx] = wg;
        sV[(iz * D + ty) * Q + tx] = wb;
      }
    }
    __syncthreads();
    // X^T sweep: (z, y, qx) -> (z, y, x), threads (x, y) = (tx, ty),
    // written straight to this component's slice of y.  (The next
    // component's Y^T writes sU/sV only after the sync that follows its
    // Z^T sweep, so these reads are ordered before it.)
    if (valid && tx < D && ty < D) {
      T* yc = y + (e * 3 + c) * D3;
      for (int iz = 0; iz < D; ++iz) {
        T out = 0;
#pragma unroll
        for (int qx = 0; qx < Q; ++qx) {
          const int o = (iz * D + ty) * Q + qx;
          out += sG[qx * D + tx] * sU[o] + sB[qx * D + tx] * sV[o];
        }
        yc[(iz * D + ty) * D + tx] = out;
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* x, const void* lam, const void* mu,
                   const void* jinv, const void* B, const void* G, void* y,
                   long long ne, cudaStream_t stream) {
  constexpr int Q = D + 1;
  const size_t bytes = Smem<T, D, Q>::kBytes;
  auto kernel = pa_elasticity_kernel<T, D, Q>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (ne + Tile<Q>::kElems - 1) / Tile<Q>::kElems;
  if (blocks == 0) return cudaSuccess;
  const dim3 block(Q, Q, Tile<Q>::kElems);
  kernel<<<static_cast<unsigned>(blocks), block, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(lam),
      static_cast<const T*>(mu), static_cast<const T*>(jinv),
      static_cast<const T*>(B), static_cast<const T*>(G),
      static_cast<T*>(y), ne);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* lam, const void* mu, const void* jinv,
             const void* B, const void* G, void* y, long long ne, int d1d,
             int q1d, void* stream) {
  if (q1d != d1d + 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (d1d) {
    case 2: err = launch<T, 2>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 3: err = launch<T, 3>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 4: err = launch<T, 4>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 5: err = launch<T, 5>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 6: err = launch<T, 6>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 7: err = launch<T, 7>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 8: err = launch<T, 8>(x, lam, mu, jinv, B, G, y, ne, s); break;
    case 9: err = launch<T, 9>(x, lam, mu, jinv, B, G, y, ne, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
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

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
