"""Attention-mask biases of M2FTrans (copy of `passion_tpu/ops/attn_mask.py`):
tensor functions of the (B, 4) modality mask, built on the mask's device.

The reference builds these masks with host loops on every forward
(code/models/mask.py:5-36); here they are a few tensor ops. The bias is
additive and finite (`NEG_INF`, not -inf), so the softmax of a row whose
every key is masked stays free of NaN.
"""

from __future__ import annotations

import torch

NUM_MODALS = 4
NEG_INF = -1e9


def fusion_attention_bias(mask: torch.Tensor,
                          tokens_per_block: int) -> torch.Tensor:
    """(B, 1, N, N) float32 bias of the bottleneck's masked self-attention,
    N = 5 * tokens_per_block: 4 modality blocks, then the fusion block.
    Modality tokens see their own block only; fusion tokens see the fusion
    block and the blocks of present modalities (mask_gen_fusion,
    code/models/mask.py:5-22)."""
    p = tokens_per_block
    block_id = torch.arange(NUM_MODALS + 1,
                            device=mask.device).repeat_interleave(p)  # (N,)
    same_block = block_id[:, None] == block_id[None, :]  # (N, N)
    row_is_fusion = (block_id == NUM_MODALS)[:, None]  # (N, 1)
    present = torch.cat([mask.to(torch.bool),
                         torch.ones((mask.shape[0], 1), dtype=torch.bool,
                                    device=mask.device)], dim=1)
    col_present = present[:, block_id]  # (B, N)
    allow = same_block[None] | (row_is_fusion[None] & col_present[:, None, :])
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(allow, zero, NEG_INF)[:, None]


def cross_key_bias(mask: torch.Tensor,
                   channels_per_modality: int) -> torch.Tensor:
    """(B, 1, 4 * channels_per_modality) float32 key bias of the channel
    cross-attention: key channels of absent modalities are masked
    (mask_gen_cross4, code/models/mask.py:25-36)."""
    allowed = mask.to(torch.bool).repeat_interleave(channels_per_modality,
                                                    dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(allowed, zero, NEG_INF)[:, None]
