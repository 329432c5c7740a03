// Shared by the flash-attention kernels of this package
// (flash_attention.cu: the mma.sync and FMA routes; flash_attention_wgmma.cu:
// the wgmma route).
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

}  // namespace flash
