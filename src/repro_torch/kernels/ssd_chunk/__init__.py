from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk

__all__ = ["ssd_chunk", "ssd_chunk_ref", "ssd_chunked_kernel"]
