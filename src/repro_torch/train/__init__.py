from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step"]
