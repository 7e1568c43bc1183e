"""EdgeKV-backed serving state: the two-tier page pool."""
from .pages import PagePoolManager, PageRef, content_key

__all__ = ["PagePoolManager", "PageRef", "content_key"]
