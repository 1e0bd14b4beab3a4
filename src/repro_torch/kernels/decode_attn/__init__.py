from repro_torch.kernels.decode_attn.decode_attn import decode_attn
from repro_torch.kernels.decode_attn.ops import (decode_attention,
                                                 paged_decode_attention)
from repro_torch.kernels.decode_attn.paged import paged_decode_attn
from repro_torch.kernels.decode_attn.ref import (decode_attn_ref,
                                                 paged_decode_attn_ref)

__all__ = ["decode_attention", "decode_attn", "decode_attn_ref",
           "paged_decode_attention", "paged_decode_attn",
           "paged_decode_attn_ref"]
