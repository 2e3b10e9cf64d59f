"""Vision Transformer classifier: the attention-native image family.

Port of ``deeplearning_mpi_tpu/models/vit.py``:

- the patch embedding is one strided conv (``models.layers.Conv``, kernel
  = stride = ``patch_size``, VALID padding, a bias, flax's LeCun init), its
  ``[B, d, h, w]`` output flattened row-major into ``h * w`` tokens;
- a zero-initialised CLS token (float32, cast to the activations' dtype) is
  prepended at position 0;
- ``num_layers`` port ``Block`` s with ``causal=False`` (bidirectional
  attention, dense: the reference's ``train_resnet`` builds its ViT with
  ``attention_fn=None``) and RoPE over the flattened patch order, so no
  parameter depends on the image size;
- ``final_norm`` on the CLS row, then a float32 head with a bias.

Images are NHWC, as the CNNs take them. ``models.convert.vit_params_from_jax``
maps the reference's tree onto this module.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from deeplearning_mpi_tpu_torch import resolve_device
from deeplearning_mpi_tpu_torch.models.layers import (
    Conv,
    Dense,
    channels_first,
    init_weights,
    lecun_normal_,
)
from deeplearning_mpi_tpu_torch.models.transformer import Block, RMSNorm, TransformerConfig


class ViT(nn.Module):
    """Patchify -> [CLS] + patches -> N bidirectional blocks -> CLS head."""

    def __init__(
        self, num_classes: int, *, patch_size: int = 4, num_layers: int = 6,
        num_heads: int = 3, head_dim: int = 64, d_model: int = 192, d_ff: int = 768,
        dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        self.num_classes, self.patch_size = num_classes, patch_size
        self.num_layers, self.num_heads, self.head_dim = num_layers, num_heads, head_dim
        self.d_model, self.d_ff = d_model, d_ff
        self.dtype = dtype
        p = patch_size
        self.patch_embed = Conv(3, d_model, (p, p), strides=(p, p), padding=[(0, 0), (0, 0)],
                                use_bias=True, dtype=dtype, init="lecun")
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model))
        # The blocks read only these widths from the config.
        block_cfg = TransformerConfig(vocab_size=1, num_layers=num_layers, num_heads=num_heads,
                                      head_dim=head_dim, d_model=d_model, d_ff=d_ff)
        self.layers = nn.ModuleList(Block(block_cfg, dtype, causal=False)
                                    for _ in range(num_layers))
        self.final_norm = RMSNorm(d_model)
        self.head = Dense(d_model, num_classes, dtype=torch.float32)
        self.to(resolve_device(device))

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> "ViT":
        """Seeded init drawn on the CPU, in registration order: the patch
        conv and the head LeCun normal (biases zero), each block projection
        LeCun truncated normal as ``TransformerLM``'s, the norms ones and
        the CLS token zeros (the reference's distributions)."""
        init_weights(self, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        for name, p in self.layers.named_parameters():
            host = torch.empty(p.shape)
            if name.endswith("scale"):
                host.fill_(1.0)
            else:
                lecun_normal_(host, p.shape[1], gen)
            p.copy_(host)
        self.final_norm.scale.fill_(1.0)
        self.cls.zero_()
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` images -> ``[B, num_classes]`` float32 logits."""
        p = self.patch_size
        if images.shape[1] % p or images.shape[2] % p:
            raise ValueError(f"image size {images.shape[1]}x{images.shape[2]} not divisible by "
                             f"patch_size {p}")
        x = self.patch_embed(channels_first(images))  # [B, d, h, w]
        batch = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, d], row-major patches
        cls = self.cls.to(x.dtype).expand(batch, 1, self.d_model)
        x = torch.cat([cls, x], dim=1)
        seq = x.shape[1]
        positions = torch.arange(seq, device=x.device)[None].expand(batch, seq)
        for block in self.layers:
            x = block(x, positions)
        cls_out = self.final_norm(x[:, 0])
        return self.head(cls_out.float())


def vit_tiny(num_classes: int = 10, **kwargs: Any) -> ViT:
    """ViT-Tiny-ish at CIFAR scale: patch 4 over 32x32 = 64 tokens + CLS."""
    return ViT(num_classes, num_layers=6, num_heads=3, head_dim=64, d_model=192, d_ff=768,
               **kwargs)


def vit_small(num_classes: int = 10, **kwargs: Any) -> ViT:
    return ViT(num_classes, num_layers=12, num_heads=6, head_dim=64, d_model=384, d_ff=1536,
               **kwargs)
