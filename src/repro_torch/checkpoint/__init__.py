from .quorum_ckpt import QuorumCheckpointer

__all__ = ["QuorumCheckpointer"]
