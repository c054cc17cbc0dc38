"""The port's multichip dry run (lightgrad_tpu_torch/parallel/dryrun.py) on
4 CPU ranks over gloo: one sharded training step per parallel form of the
JAX package's ``dryrun_multichip`` -- BERT over dp x tp x sp with ring
attention, GPT-2 blocks through the 1F1B and the interleaved-1F1B
pipelines, GPT-MoE over ep, T5 over dp x tp, GPT-2 under fsdp and under
fsdp x tp -- each loss finite (the FSDP legs also check a weight's local
shard shape).  Spawned ranks import no JAX."""

import numpy as np

from lightgrad_tpu_torch.parallel.dryrun import LEGS, dryrun_multichip


def test_dryrun_multichip_on_four_cpu_ranks():
    got = dryrun_multichip(4, device="cpu", timeout=300)
    assert got["mesh"] == (1, 2, 2)
    for leg in ("bert", "1f1b", "interleaved", "moe", "t5", "fsdp",
                "fsdp_tp"):
        assert np.all(np.isfinite(got[leg])), (leg, got[leg])
    # three steps of each trained model: the loss falls
    for leg in ("bert", "moe", "t5", "fsdp", "fsdp_tp"):
        assert got[leg][-1] < got[leg][0], (leg, got[leg])
    assert set(LEGS) == {"bert", "pipeline", "moe", "t5", "fsdp", "fsdp_tp"}
