"""The port's hand-written kernels (CUDA C++ and Triton), each beside its
plain PyTorch twin.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version.  Kernels build at first use
(``_build.library`` for CUDA, Triton's own compiler for Triton)."""

from .attention import (attention_bwd, attention_bwd_dkv, attention_bwd_dq,
                        attention_bwd_fused, attention_bwd_fused_reference,
                        attention_bwd_reference, attention_fwd,
                        attention_fwd_res, attention_fwd_reference,
                        flash_block_bwd, flash_block_fwd,
                        flash_block_reference, set_flash_fused)
from .conv import (conv_bwd, conv_bwd_reference, conv_fwd,
                   conv_fwd_reference)
from .decode_attention import (decode_attention, decode_attention_batch,
                               decode_attention_batch_reference,
                               decode_attention_reference)
from .decode_stack import (decode_stack, decode_stack_batch,
                           decode_stack_batch_reference,
                           decode_stack_reference, pack_gpt_stack,
                           stack_supported)
from .elementwise import ew, ew_reference
from .layernorm import (layernorm_bwd_dx, layernorm_bwd_dx_reference,
                        layernorm_fwd, layernorm_fwd_reference)
from .matmul import (matmul, matmul_default_reference, matmul_reference,
                     matmul_tf32x3_reference, matmul_vjp)
from .reduce import reduce, reduce_reference
from .runtime import (KERNELS, device_kind, device_name, kernels_in_use,
                      launch_counts, reset_launch_counts)
from .softmax import (softmax_bwd, softmax_bwd_reference, softmax_fwd,
                      softmax_fwd_reference)
