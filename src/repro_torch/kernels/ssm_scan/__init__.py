from .kernel import ssm_scan_kernel
from .ops import ssm_scan
from .ref import ssd_chunked_ref, ssd_ref

__all__ = ["ssd_chunked_ref", "ssd_ref", "ssm_scan", "ssm_scan_kernel"]
