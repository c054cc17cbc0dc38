"""ResNet vision family: residual conv blocks with BatchNorm.

Counterpart of ``lightgrad_tpu/models/resnet.py`` on the port's lightgrad
tape, with its names (``stem``, ``bstem``, ``blocks.{i}.c1/b1/c2/b2/proj/
bproj``, ``fc``): the CIFAR-style ResNets of He et al. (depth 6n+2) and the
torchvision ResNet-18 layout.  The convolutions run the implicit-GEMM conv
kernels, BatchNorm and the residual adds the elementwise and reduce
kernels, the head the matmul kernel.
"""

import numpy as np
import torch

from .. import nn

__all__ = ["BasicBlock", "ResNet", "resnet20", "resnet18",
           "load_torchvision_state_dict"]


class BasicBlock(nn.Module):
    """conv3x3-BN-relu-conv3x3-BN + skip (1x1-conv-BN projection when the
    shape changes)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.c1 = nn.Conv2d(in_ch, out_ch, kernelsize=3, stride=stride,
                            pad=1, bias=False)
        self.b1 = nn.BatchNorm2d(out_ch)
        self.c2 = nn.Conv2d(out_ch, out_ch, kernelsize=3, stride=1, pad=1,
                            bias=False)
        self.b2 = nn.BatchNorm2d(out_ch)
        if stride != 1 or in_ch != out_ch:
            self.proj = nn.Conv2d(in_ch, out_ch, kernelsize=1, stride=stride,
                                  pad=0, bias=False)
            self.bproj = nn.BatchNorm2d(out_ch)
        else:
            self.proj = None

    def forward(self, x):
        y = self.b1(self.c1(x)).relu()
        y = self.b2(self.c2(y))
        skip = self.bproj(self.proj(x)) if self.proj is not None else x
        return (y + skip).relu()


class ResNet(nn.Module):
    """Residual network over (B, C, H, W) inputs.

    ``stage_blocks``: blocks per stage; ``stage_channels``: channel width per
    stage (stages after the first downsample with stride 2).  Classification
    head = global average pool + linear."""

    def __init__(self, stage_blocks, stage_channels, num_classes: int = 10,
                 in_channels: int = 3, stem_kernel: int = 3,
                 stem_stride: int = 1, stem_pool: bool = False):
        super().__init__()
        c0 = stage_channels[0]
        self.stem = nn.Conv2d(in_channels, c0, kernelsize=stem_kernel,
                              stride=stem_stride, pad=stem_kernel // 2,
                              bias=False)
        self.bstem = nn.BatchNorm2d(c0)
        # ImageNet-style stem: overlapping 3x3/s2/p1 max pool after the conv
        self.stem_pool = stem_pool
        blocks = []
        in_ch = c0
        for si, (n, ch) in enumerate(zip(stage_blocks, stage_channels)):
            for bi in range(n):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(BasicBlock(in_ch, ch, stride=stride))
                in_ch = ch
        self.blocks = nn.ModuleList(*blocks)
        self.fc = nn.Linear(in_ch, num_classes)

    def forward(self, x):
        y = self.bstem(self.stem(x)).relu()
        if self.stem_pool:
            y = y.max_pool2d(kernel=(3, 3), stride=(2, 2), padding=1)
        for blk in self.blocks:
            y = blk(y)
        # global average pool over H, W
        y = y.mean(axis=(2, 3))
        return self.fc(y)


def resnet20(num_classes: int = 10, in_channels: int = 3) -> ResNet:
    """CIFAR ResNet-20 (He et al.: 3 stages x 3 blocks, 16/32/64 channels)."""
    return ResNet([3, 3, 3], [16, 32, 64], num_classes=num_classes,
                  in_channels=in_channels)


def resnet18(num_classes: int = 1000, in_channels: int = 3) -> ResNet:
    """torchvision-faithful ResNet-18 (4 stages x 2 blocks, 64..512;
    conv7/s2 stem + overlapping 3x3/s2 max pool) -- same architecture as
    ``torchvision.models.resnet18``, so its checkpoints load directly via
    ``load_torchvision_state_dict``."""
    return ResNet([2, 2, 2, 2], [64, 128, 256, 512],
                  num_classes=num_classes, in_channels=in_channels,
                  stem_kernel=7, stem_stride=2, stem_pool=True)


def load_torchvision_state_dict(model: ResNet, state: dict,
                                stage_blocks=(2, 2, 2, 2)) -> ResNet:
    """Load a torchvision BasicBlock-ResNet checkpoint (resnet18/34 layout)
    into ``model``.

    Maps torchvision names (``conv1/bn1``, ``layer{L}.{B}.conv1/bn1/conv2/
    bn2/downsample.{0,1}``, ``fc``) onto ours (``stem/bstem``,
    ``blocks.{i}.c1/b1/c2/b2/proj/bproj``, ``fc``); weight layouts already
    agree (Conv2d ``(out, in, kh, kw)``, Linear ``(out, in)``).  ``state``
    values may be numpy arrays or torch tensors (``torchvision``'s
    ``state_dict()``); ``num_batches_tracked`` buffers are dropped (the
    BatchNorm uses a fixed momentum)."""
    flat_of = {}
    idx = 0
    for li, n in enumerate(stage_blocks):
        for bi in range(n):
            flat_of[(li + 1, bi)] = idx
            idx += 1

    def put(dst: str, key: str):
        v = state[key]
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        mapped[dst] = np.asarray(v)

    mapped = {}
    put("stem.w", "conv1.weight")  # our Conv2d names its kernel ``w``
    for suf in ("weight", "bias", "running_mean", "running_var"):
        put(f"bstem.{suf}", f"bn1.{suf}")
    for (li, bi), i in flat_of.items():
        pre_tv, pre = f"layer{li}.{bi}.", f"blocks.{i}."
        put(pre + "c1.w", pre_tv + "conv1.weight")
        put(pre + "c2.w", pre_tv + "conv2.weight")
        for tb, ob in (("bn1", "b1"), ("bn2", "b2")):
            for suf in ("weight", "bias", "running_mean", "running_var"):
                put(f"{pre}{ob}.{suf}", f"{pre_tv}{tb}.{suf}")
        if f"{pre_tv}downsample.0.weight" in state:
            put(pre + "proj.w", pre_tv + "downsample.0.weight")
            for suf in ("weight", "bias", "running_mean", "running_var"):
                put(f"{pre}bproj.{suf}", f"{pre_tv}downsample.1.{suf}")
    for suf in ("weight", "bias"):
        put(f"fc.{suf}", f"fc.{suf}")
    model.load_parameters(mapped)
    return model
