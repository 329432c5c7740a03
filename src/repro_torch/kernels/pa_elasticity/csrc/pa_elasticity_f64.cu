// pa_elasticity.cu's float64 entry points (and kernel_error_string): one
// translation unit of three, compiled by its own nvcc beside the others.
#define PA_ELASTICITY_DTYPE 64
#include "pa_elasticity.cu"
