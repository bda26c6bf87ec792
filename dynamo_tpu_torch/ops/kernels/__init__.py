"""Hand-written CUDA kernels for Hopper (counterparts of the Pallas kernels
in dynamo_tpu/ops/pallas) and their wrappers.  Importing this package
builds nothing: ``build.library()`` compiles on first launch."""

from dynamo_tpu_torch.ops.kernels.block_copy import gather_blocks, scatter_blocks
from dynamo_tpu_torch.ops.kernels.mla_attention import (
    mla_paged_attention_decode,
    mla_paged_window_attention_decode,
    ragged_mla_attention,
)
from dynamo_tpu_torch.ops.kernels.paged_attention import (
    paged_attention_decode,
    paged_window_attention_decode,
)
from dynamo_tpu_torch.ops.kernels.ragged_attention import (
    pack_page_meta,
    ragged_paged_attention,
)

__all__ = [
    "gather_blocks",
    "mla_paged_attention_decode",
    "mla_paged_window_attention_decode",
    "pack_page_meta",
    "paged_attention_decode",
    "paged_window_attention_decode",
    "ragged_mla_attention",
    "ragged_paged_attention",
    "scatter_blocks",
]
