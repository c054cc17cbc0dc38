// The whole-stack decode kernel of decode_stack.cu for bf16 compute, bf16 weights, with
// either cache type: one of the four translation units the library's build
// compiles the kernel's eight instantiations in, in parallel.
#define LG_STACK_PART
#include "decode_stack.cu"

LG_STACK_PART_FN(2, __nv_bfloat16, __nv_bfloat16)
