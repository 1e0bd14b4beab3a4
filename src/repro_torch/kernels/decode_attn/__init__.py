from repro_torch.kernels.decode_attn.ops import paged_decode_attention
from repro_torch.kernels.decode_attn.paged import paged_decode_attn
from repro_torch.kernels.decode_attn.ref import paged_decode_attn_ref

__all__ = ["paged_decode_attention", "paged_decode_attn",
           "paged_decode_attn_ref"]
