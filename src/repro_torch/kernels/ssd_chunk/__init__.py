from repro_torch.kernels.ssd_chunk.ops import ssd_chunked_kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_chunk.ssd_chunk import (SSDChunkFunction,
                                                     ssd_chunk)

__all__ = ["SSDChunkFunction", "ssd_chunk", "ssd_chunk_ref",
           "ssd_chunked_kernel"]
