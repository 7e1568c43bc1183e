"""Device times of K4's decode configuration at every key split count, on
a GPU: the evidence for ``kernel.decode_splits`` and
``kernel.int8_decode_splits``, kept out of ``chip_smoke.py`` so that
the smoke does not pay for it.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.decode_sweep

For each serve path's decode call (8 requests, one query over a
1056-slot cache whose valid length, a device int32, is 1025; the audio
cross-attention over 1024 frames; granite-20b's MQA group of 48) it
prints the rule's split count and the device time (torch.profiler, 20
back-to-back launches) at 1, 2, 4 and 8 splits, each against its byte
bound, every split count's output held to the rule's within 2e-5 x
max(1, |o|).  It then times mixtral-8x7b's GQA call (32 query heads over
8 KV heads: the 4-row instance) against the same K and V read by 8 query
heads (the 1-row instance).  The int8 instance follows, the same way, at
``chip_smoke.py``'s ``INT8_FLASH`` shapes (K/V quantized symmetric
int8 per row, hd + 4 bytes a K or V row), against its own rule.  Last,
the registers and spill bytes ptxas gave each decode instance and the
CTAs of 256 threads those registers leave an SM.
"""
from __future__ import annotations

import re

import torch

from .. import cuda_build
from . import kernel as fk

B, S_MAX, KV_LEN = 8, 1056, 1025
HBM = 3.35e12        # an H100 SXM's device memory, bytes/s
TOL = 2e-5
# (what, H, K, hd, Skv, valid length or None for all of it)
SHAPES = (("stablelm-3b", 32, 32, 80, S_MAX, KV_LEN),
          ("zamba2-1.2b", 32, 32, 64, S_MAX, KV_LEN),
          ("mixtral-8x7b", 32, 8, 128, S_MAX, KV_LEN),
          ("mixtral-8x7b K/V, 8 query heads", 8, 8, 128, S_MAX, KV_LEN),
          ("seamless-m4t-large-v2 decoder self", 16, 16, 64, S_MAX, KV_LEN),
          ("seamless-m4t-large-v2 cross", 16, 16, 64, 1024, None),
          ("granite-20b (MQA)", 48, 1, 128, S_MAX, KV_LEN))
# the int8 instance: (what, H, K, hd, valid length), over S_MAX slots
INT8_SHAPES = (("stablelm-3b", 32, 32, 80, KV_LEN),
               ("stablelm-3b kv_len 1055", 32, 32, 80, 1055),
               ("mixtral-8x7b", 32, 8, 128, KV_LEN),
               ("seamless-m4t-large-v2 decoder self", 16, 16, 64, KV_LEN),
               ("granite-20b (MQA)", 48, 1, 128, KV_LEN))


def device_ms(fn, calls: int = 20) -> float:
    """Summed durations of the CUDA kernels of ``calls`` calls, a call."""
    from torch.autograd import DeviceType
    for _ in range(3):   # the profiler, rarely, sees no kernel in a window
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError("torch.profiler saw no device time")


def quantize(x):
    """Symmetric int8 codes of x (..., hd) and their float32 scales
    (..., 1): amax / 127 a row, rounded half to even and clamped."""
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


def registers() -> list:
    """(K/V type, head columns a lane / 32, rows, registers, spill store
    bytes, spill load bytes) of each decode instance, from ptxas's log
    of this process's build."""
    log = cuda_build.BUILD_LOG.get("flash_fwd", "")
    out = []
    for m in re.finditer(r"Compiling entry function '\S*flash_decode_kernel"
                         r"ILi(\d+)ELi(\d+)E([fa])E\S*'.*?(\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads.*?Used (\d+) "
                         r"registers", log, re.S):
        dj, rows, kv, stores, loads, regs = m.groups()
        out.append(("int8" if kv == "a" else "float32", int(dj), int(rows),
                    int(regs), int(stores), int(loads)))
    return sorted(set(out))


def sweep(what: str, shape: str, q, k, v, kv_len, rule: int, nbytes: int,
          kv_scales=None) -> None:
    """Times one decode call at 1, 2, 4 and 8 splits, each held to the
    ``rule`` splits' output, and prints them against the byte bound."""
    skv = k.shape[1]
    bound = nbytes / HBM * 1e3
    want = fk._launch(q, k, v, False, 0, kv_len, rule, kv_scales)
    scale = max(1.0, float(want.abs().max()))
    times = []
    for split in (1, 2, 4, 8):
        if split > -(-skv // fk.TILE):
            continue

        def run(s=split):
            return fk._launch(q, k, v, False, 0, kv_len, s, kv_scales)

        err = float((run() - want).abs().max())
        if err > TOL * scale:
            raise AssertionError(f"{what}: {split} splits differ from "
                                 f"{rule} by {err}")
        ms = device_ms(run)
        times.append(f"{split} {ms:.4f} ms ({bound / ms:.0%})")
    print(f"decode_sweep {what} {shape}: bound {bound:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at {HBM / 1e12:.2f} TB/s); rule {rule} "
          f"splits; at " + ", ".join(times), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_sweep: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    sms = fk._sm_count(0)
    cuda_build.build()
    mixtral_k = None
    for what, H, K, hd, skv, n in SHAPES:
        if what.startswith("mixtral-8x7b K/V"):
            k, v = mixtral_k   # the same K and V as the GQA call
        else:
            k, v = (torch.randn(B, skv, K, hd, generator=gen, device=dev)
                    for _ in range(2))
        if what == "mixtral-8x7b":
            mixtral_k = k, v
        q = torch.randn(B, 1, H, hd, generator=gen, device=dev)
        kv_len = None if n is None else torch.tensor(
            n, dtype=torch.int32, device=dev)
        valid = skv if n is None else n
        sweep(what, f"(B {B}, H {H}, K {K}, hd {hd}, Skv {skv}, kv_len "
              f"{valid})", q, k, v, kv_len,
              fk.decode_splits(B * K, H // K, skv, sms),
              4 * (2 * B * H * hd + 2 * B * valid * K * hd))
    for what, H, K, hd, n in INT8_SHAPES:
        (k, ks), (v, vs) = (quantize(torch.randn(
            B, S_MAX, K, hd, generator=gen, device=dev)) for _ in range(2))
        q = torch.randn(B, 1, H, hd, generator=gen, device=dev)
        sweep(f"int8 {what}", f"(B {B}, H {H}, K {K}, hd {hd}, Skv "
              f"{S_MAX}, kv_len {n})", q, k, v,
              torch.tensor(n, dtype=torch.int32, device=dev),
              fk.int8_decode_splits(B * K, H // K, S_MAX, sms),
              4 * 2 * B * H * hd + 2 * B * n * K * (hd + 4), (ks, vs))
    for kv, dj, rows, regs, stores, loads in registers():
        print(f"decode_sweep {kv} instance hd <= {32 * dj}, {rows} rows: "
              f"{regs} registers a thread, {stores} and {loads} bytes of "
              f"spill stores and loads, "
              f"{65536 // (256 * -(-regs // 8) * 8)} CTAs of 256 threads an "
              f"SM by registers", flush=True)


if __name__ == "__main__":
    main()
