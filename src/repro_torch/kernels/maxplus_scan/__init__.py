from .kernel import maxplus_chunked, maxplus_seq
from .ops import maxplus_depart
from .ref import maxplus_chunked_ref, maxplus_depart_ref

__all__ = ["maxplus_chunked", "maxplus_chunked_ref", "maxplus_depart",
           "maxplus_depart_ref", "maxplus_seq"]
