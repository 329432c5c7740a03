// pa_elasticity.cu's bfloat16 entry points: one translation unit of three,
// compiled by its own nvcc beside the others.
#define PA_ELASTICITY_DTYPE 16
#include "pa_elasticity.cu"
