"""The parallel layer on ``torch.distributed``: meshes, the partition rules
over ``DTensor``, ring attention, the three pipeline schedules and the
process groups.

Counterpart of ``lightgrad_tpu/parallel/``, export for export.  One process
drives one device (SPMD, launched as ``torchrun`` launches it): a sharded
array is a ``DTensor`` on a named ``DeviceMesh``, the kernels run on its
local shards by the placement strategies they declare (ops/runtime.py),
and where the JAX package drops into ``shard_map`` the port works on
``to_local()`` shards with explicit collectives on the mesh dim's process
group.
"""

from .mesh import make_mesh
from .shard import (shard_module, shard_tensor, partition_rules,
                    BERT_TP_RULES, GPT_TP_RULES, LLAMA_TP_RULES, T5_TP_RULES, MOE_EP_RULES,
                    GPT_MOE_RULES, LLAMA_MOE_RULES, NEOX_TP_RULES,
                    enable_sequence_parallel, fsdp_spec, fsdp_module)
from .pipeline import pipeline_apply, pipeline_apply_interleaved
from .pipeline_1f1b import pipeline_train_1f1b
from .pipeline_1f1b_interleaved import pipeline_train_1f1b_interleaved
from .ring_attention import ring_attention, ring_attention_sharded
from . import distributed
