// pa_elasticity.cu's float32 entry points: one translation unit of three,
// compiled by its own nvcc beside the others.
#define PA_ELASTICITY_DTYPE 32
#include "pa_elasticity.cu"
