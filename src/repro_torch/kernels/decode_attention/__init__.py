from .ops import decode_attention, decode_attention_partials
from .ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_partials",
           "decode_attention_ref"]
