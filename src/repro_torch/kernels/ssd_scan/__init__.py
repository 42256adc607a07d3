from .ops import ssd, ssd_chunk
from .ref import ssd_chunk_ref, ssd_chunked, ssd_reference

__all__ = ["ssd", "ssd_chunk", "ssd_chunk_ref", "ssd_chunked",
           "ssd_reference"]
