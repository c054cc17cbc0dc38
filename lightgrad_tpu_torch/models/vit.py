"""Vision Transformer (ViT) on the lightgrad tape: config, encoder,
classification head.

Counterpart of ``lightgrad_tpu/models/vit.py``, with its module and
parameter names, which follow HuggingFace ``google/vit-base-patch16-224``
(``remap_hf_state`` / ``from_pretrained``).  The patch embedding is a
stride-P convolution, so on the card the conv kernels run it (3 input
channels staged as 4 for float32, 8 for bf16: the tensor-core route, as
ResNet's stem); the encoder reuses BERT's self-attention, unmasked, so
attention is the flash kernels at S = patches + 1 (197 for ViT-B/16, not
a multiple of their tiles); the blocks are pre-LN; ``scan_layers=True``
holds them as one :class:`~lightgrad_tpu_torch.scan.ScannedStack`.
"""

import io
import json

import torch

from .. import nn
from ..autograd import Tensor, no_grad
from ..scan import ScannedStack
from .bert import BertSelfAttention

__all__ = ["ViTConfig", "ViTModel", "ViTForImageClassification"]


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, num_channels=3,
                 hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 layer_norm_eps=1e-12, num_labels=1000,
                 scan_layers=False, remat=False, **unused):
        assert image_size % patch_size == 0, (image_size, patch_size)
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_channels = num_channels
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.layer_norm_eps = layer_norm_eps
        self.num_labels = num_labels
        self.scan_layers = scan_layers
        self.remat = remat
        self.num_patches = (image_size // patch_size) ** 2


class ViTEmbeddings(nn.Module):
    """Patchify + linear projection + [CLS] + learned position embeddings."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h, n = cfg.hidden_size, cfg.num_patches
        self.cls_token = Tensor.zeros((1, 1, h))
        with no_grad():
            pos = Tensor.uniform(-1, 1, (1, n + 1, h)) * 0.02
        self.position_embeddings = pos.detach()._set_requires_grad(True)
        self.projection = nn.Conv2d(cfg.num_channels, h,
                                    kernelsize=cfg.patch_size,
                                    stride=cfg.patch_size, pad=0)

    def forward(self, pixels):
        b = pixels.shape[0]
        x = self.projection(pixels)                # (b, h, H/P, W/P)
        bh, hh, gh, gw = x.shape
        x = x.reshape(bh, hh, gh * gw).transpose(0, 2, 1)  # (b, n, h)
        # the CLS token over the batch: adding zeros is the differentiable
        # expand (the tape's unbroadcast sums its gradient over the batch);
        # the zeros take x's dtype, so a bf16 model stays bf16
        cls = self.cls_token + type(x).zeros((b, 1, x.shape[-1]),
                                             requires_grad=False,
                                             dtype=x.dtype)
        x = cls.concat(x, axis=1)
        return x + self.position_embeddings


class ViTLayer(nn.Module):
    """Pre-LN encoder block (ViT normalises before each branch, BERT
    after)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layernorm_before = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.attention = BertSelfAttention(cfg)
        self.attn_output = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.layernorm_after = nn.LayerNorm(cfg.hidden_size,
                                            eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        x = x + self.attn_output(self.attention(self.layernorm_before(x)))
        return x + self.output(
            self.intermediate(self.layernorm_after(x)).gelu())


class ViTModel(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ViTEmbeddings(cfg)
        blocks = [ViTLayer(cfg) for _ in range(cfg.num_hidden_layers)]
        if cfg.scan_layers:
            self.layer = ScannedStack(blocks, remat=cfg.remat)
        else:
            self.layer = nn.ModuleList(*blocks)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels):
        x = self.embeddings(pixels)
        if isinstance(self.layer, nn.ModuleList):
            for layer in self.layer:
                x = layer(x)
        else:
            x = self.layer(x)
        return self.layernorm(x)


class ViTForImageClassification(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.vit = ViTModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, cfg.num_labels)

    def forward(self, pixels):
        x = self.vit(pixels)             # (b, n+1, h)
        return self.classifier(x[:, 0])  # logits from the CLS position

    @staticmethod
    def remap_hf_state(state: dict) -> dict:
        """HuggingFace ViTForImageClassification names -> ours.

        HF nests self-attention as ``attention.attention.{query,key,value}``
        and its projection as ``attention.output.dense``; the patch
        embedding is ``embeddings.patch_embeddings.projection``; the pooler
        is dropped.
        """
        out = {}
        for hf_name, arr in state.items():
            name = hf_name
            name = name.replace("vit.encoder.layer.", "vit.layer.")
            name = name.replace(".attention.attention.", ".attention.")
            name = name.replace(".attention.output.dense.", ".attn_output.")
            name = name.replace(".intermediate.dense.", ".intermediate.")
            name = name.replace(".output.dense.", ".output.")
            # Conv2d names its parameters w / b (bias stored (1, out, 1, 1))
            if name == "vit.embeddings.patch_embeddings.projection.weight":
                name = "vit.embeddings.projection.w"
            elif name == "vit.embeddings.patch_embeddings.projection.bias":
                name = "vit.embeddings.projection.b"
                arr = arr.reshape(1, -1, 1, 1)
            out[name] = arr
        return {k: v for k, v in out.items()
                if not k.startswith("vit.pooler.")}

    @staticmethod
    def from_pretrained(name: str = "google/vit-base-patch16-224"):
        """(model, config) of an HF repository's ``config.json`` and
        ``pytorch_model.bin``, through :func:`utils.fetch` (which reads a
        file named md5(url) from ``LIGHTGRAD_CACHE`` before the network),
        the weights by ``torch.load(weights_only=True)``."""
        from ..utils import fetch

        url = f"https://huggingface.co/{name}/resolve/main/"
        hf_cfg = json.loads(fetch(url + "config.json"))
        cfg = ViTConfig(num_labels=len(hf_cfg.get("id2label", [])) or 1000,
                        **hf_cfg)
        model = ViTForImageClassification(cfg)
        state = torch.load(io.BytesIO(fetch(url + "pytorch_model.bin")),
                           map_location="cpu", weights_only=True)
        model.load_parameters(ViTForImageClassification.remap_hf_state(state))
        return model, cfg
