"""Hand-written CUDA kernels for the port's hot spots, each package with
kernel.py (bindings and launch wrappers over ``csrc/``), ops.py (the
entry point) and ref.py (plain PyTorch versions, which CPU tensors run);
``cuda_build`` compiles and loads every package's sources:

* maxplus_scan — the EdgeKV simulator's leader-stage departure
  recurrence, batched over rows; the numeric core of the batched sweep
  engine (repro_torch.sim.sweep).
* ssm_scan — the chunked SSD scan of the SSM family's sequence mixing
  (mLSTM in xlstm; repro_torch.models.ssm).
* flash_attention — block online-softmax attention, every attention
  call of the dense family (stablelm; repro_torch.models.attention).
* paged_attention — one-token decode attention over the EdgeKV page
  pool (repro_torch.edgecache) through int32 page tables, online softmax
  across the pages.
"""
from .flash_attention import flash_attention
from .maxplus_scan import maxplus_depart
from .paged_attention import paged_attention
from .ssm_scan import ssm_scan

__all__ = ["flash_attention", "maxplus_depart", "paged_attention",
           "ssm_scan"]
