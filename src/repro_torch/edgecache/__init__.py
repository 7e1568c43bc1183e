"""EdgeKV-backed serving state: the two-tier page pool and expert
placement."""
from .pages import PagePoolManager, PageRef, content_key
from .experts import expert_placement, apply_expert_permutation

__all__ = ["PagePoolManager", "PageRef", "content_key",
           "expert_placement", "apply_expert_permutation"]
