"""Device facts for the port's kernels.

The port has no kernel-mode switch: a wrapper given CUDA tensors launches its
hand-written kernel (or raises), and a wrapper given CPU tensors runs the
kernel's plain PyTorch version.  The device of the tensors is the only
dispatch rule, so this module only reports what that rule will do.
"""

import torch

__all__ = ["device_kind", "device_name", "kernels_in_use", "KERNELS",
           "COPIES", "launch_counts", "reset_launch_counts"]

# Every hand-written kernel of the port, by wrapper name.  A wrapper adds one
# to its count where it launches its kernel, and nowhere else.  The stack
# kernel's int8 instantiations count under their own names, as the JAX
# package has a Pallas variant for each.  ``flash_block`` counts one in each
# direction, beside the flash kernels it launches.  Decode attention counts
# its split kernel once a call (``decode_attention_batch``: once for all
# slots) and, where it splits a head's keys, the merge of the splits under
# its own name.  Convolution counts each route under its own names (the
# tensor-core kernels as ``conv_*``, the CUDA-core ones as ``conv_*_simt``),
# and the tensor-core route's channels-last staging as ``conv_layout``, one
# a staged tensor.
KERNELS = ("attention_fwd", "decode_attention", "decode_attention_batch",
           "decode_attention_merge",
           "decode_stack", "decode_stack_batch", "decode_stack_int8",
           "decode_stack_kvq",
           "decode_stack_int8_kvq", "decode_stack_batch_int8",
           "decode_stack_batch_kvq", "decode_stack_batch_int8_kvq",
           "attention_bwd_dq", "attention_bwd_dkv", "attention_bwd_fused",
           "flash_block", "layernorm_fwd", "layernorm_bwd", "elementwise",
           "reduce", "matmul", "softmax_fwd", "softmax_bwd", "conv_fwd",
           "conv_bwd_dx", "conv_bwd_dw", "conv_layout", "conv_fwd_simt",
           "conv_bwd_dx_simt", "conv_bwd_dw_simt")
# Copies a wrapper makes before a launch, counted beside the kernels: the
# matmul wrapper's packing of an operand whose batch strides the kernel
# cannot walk; the elementwise wrapper's copy of a view whose strides do not
# merge into the kernel's 4 dims.
COPIES = ("matmul_pack", "elementwise_copy")
_launches = dict.fromkeys(KERNELS + COPIES, 0)


def count_launch(name: str):
    _launches[name] += 1


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(_launches)


def reset_launch_counts():
    for name in _launches:
        _launches[name] = 0


def device_kind(t: torch.Tensor = None) -> str:
    """'cuda' or 'cpu': of ``t`` when given, else of the default card."""
    if t is not None:
        return t.device.type
    return "cuda" if torch.cuda.is_available() else "cpu"


def device_name() -> str:
    """The card's name (``torch.cuda.get_device_name(0)``), or 'cpu'."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def kernels_in_use(t: torch.Tensor) -> bool:
    """True exactly when a wrapper given ``t`` launches its CUDA kernel."""
    return t.is_cuda
