// Shared by the flash-attention kernels of this package
// (flash_attention.cu: the mma.sync and FMA routes; flash_attention_wgmma.cu:
// the wgmma route; flash_attention_bwd.cu and flash_attention_bwd_wgmma.cu:
// the backward).
#pragma once

namespace flash {

// Masked score, the reference's NEG_INF; masked probabilities are 0
// (mask-aware exp), never exp(NEG_INF - NEG_INF).
constexpr float kNegInf = -1e30f;
// Floor of the softmax sum in the final divide: o = acc / max(l, kMinL).
constexpr float kMinL = 1e-30f;

// Error codes of the entry points beside cudaError_t's (which are >= 0).
constexpr int kErrRoute = -1;       // arguments outside this entry point's route
constexpr int kErrNoEncoder = -2;   // the driver has no cuTensorMapEncodeTiled
constexpr int kErrTensorMap = -3;   // cuTensorMapEncodeTiled refused a q/k/v map

// Row pitch of the backward's per-row f32 scratch (delta, and the wgmma
// route's log2 LSE): S rounded up to 128, so every TMA box of it is in bounds.
inline long long bwd_pitch(int S) { return (S + 127LL) / 128 * 128; }

// The backward's delta pass on bf16 o and dO (flash_attention_bwd.cu):
// delta (B, H, bwd_pitch(S)) = rowsum(dO o o) in f32, 0 past S, and lse2 the
// forward's natural-log LSE (B, H, S) in log2 units, +inf past S.  Returns a
// CUDA error (0: launched).
int bwd_prep_bf16(const void* o, const void* dout, const float* lse, float* delta, float* lse2,
                  int B, int S, int H, int D, long long osb, long long oss, long long osh,
                  long long dosb, long long doss, long long dosh, void* stream);

}  // namespace flash

// The backward entry points' arguments (flash_attention_bwd.cu,
// flash_attention_bwd_wgmma.cu): q, k, v, o, dO, dq, dk, dv, the forward's
// LSE, the delta scratch; sizes; element strides of (b, s, h) of the eight
// tensors; the stream.
#define BWD_ARGS                                                                      \
  const void *q, const void *k, const void *v, const void *o, const void *dout,      \
      void *dq, void *dk, void *dv, const void *lse, void *delta, int B, int S, int H, int K, \
      int D, int window, long long qsb, long long qss, long long qsh, long long ksb,  \
      long long kss, long long ksh, long long vsb, long long vss, long long vsh,      \
      long long osb, long long oss, long long osh, long long dosb, long long doss,    \
      long long dosh, long long dqsb, long long dqss, long long dqsh, long long dksb, \
      long long dkss, long long dksh, long long dvsb, long long dvss, long long dvsh, \
      void *stream
