// The whole-stack decode kernel of decode_stack.cu for f32 compute, f32 weights, with
// either cache type: one of the four translation units the library's build
// compiles the kernel's eight instantiations in, in parallel.
#define LG_STACK_PART
#include "decode_stack.cu"

LG_STACK_PART_FN(0, float, float)
