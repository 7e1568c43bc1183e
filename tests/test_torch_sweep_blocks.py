"""The port's closed sweep in point blocks (``devices`` > 1): bitwise
equal to one block, with uneven blocks, a clamped single point and the
eviction regime, which ignores ``devices``; and the CUDA rule for
visible devices, run here with the CUDA queries monkeypatched."""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import sweep as ref_sweep
from repro_torch.sim import sweep
from repro_torch.sim.cluster import ServiceParams
from repro_torch.sim.sweep import SweepPoint, closed_grid, run_sweep

GRID = closed_grid(threads=4, ops=32)
UNEVEN = GRID[:5] + [SweepPoint(p_global=0.5, groups=4, threads=6, ops=48)]
EVICT = [SweepPoint(p_global=0.5, groups=3, threads=8, ops=64),
         SweepPoint(p_global=0.0, groups=3, threads=8, ops=64,
                    distribution="zipfian"),
         SweepPoint(p_global=1.0, groups=4, threads=4, ops=48)]
SMALL_CACHE = dict(page_cache_keys=16)


def closed(points, devices, **kw):
    return run_sweep(points, loop="closed", seed=0, devices=devices,
                     device="cpu", **kw)


def assert_bitwise(got, want):
    assert set(got.columns) == set(want.columns)
    for k, w in want.columns.items():
        assert np.array_equal(got.columns[k], w, equal_nan=True), k


@pytest.mark.parametrize("devices", [2, 3, 8])
def test_blocks_bitwise_equal_to_one_block(devices):
    one = closed(GRID, 1)
    many = closed(GRID, devices)
    assert_bitwise(many, one)
    assert one.info["blocks"] == 1 and many.info["blocks"] == devices
    # the common padded grid: rows of the largest block, slots of the
    # longest row anywhere
    assert many.info["grid"][1] == one.info["grid"][1]
    assert many.info["grid"][0] < one.info["grid"][0]
    assert many.info["rounds"] == one.info["rounds"]


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_uneven_blocks_bitwise(devices):
    """Six points over blocks that do not divide them (8 clamps to 6),
    one point larger than the rest, so every block is padded."""
    many = closed(UNEVEN, devices)
    assert_bitwise(many, closed(UNEVEN, 1))
    assert many.info["blocks"] == min(devices, 6)


def test_single_point_clamps_to_one_block():
    one, eight = closed(UNEVEN[-1:], 1), closed(UNEVEN[-1:], 8)
    assert_bitwise(eight, one)
    assert eight.info["blocks"] == 1
    assert eight.info["grid"] == one.info["grid"]


def assert_matches_reference(got, points, **kw):
    """Every column within 1e-9 of the reference's run, nan where it is."""
    want = ref_sweep.run_sweep(
        [ref_sweep.SweepPoint(**asdict(p)) for p in points], loop="closed",
        seed=0, **kw)
    for k, w in want.columns.items():
        g = got.columns[k]
        assert np.array_equal(np.isnan(g), np.isnan(w)), k
        ok = ~np.isnan(w)
        assert np.all(np.abs(g[ok] - w[ok])
                      <= 1e-9 * np.maximum(1.0, np.abs(w[ok]))), k


def test_eviction_regime_ignores_devices():
    svc = ServiceParams(**SMALL_CACHE)
    one = closed(EVICT, 1, service=svc)
    eight = closed(EVICT, 8, service=svc)
    assert one.info["rounds"] is None and eight.info["blocks"] is None
    assert_bitwise(eight, one)
    assert_matches_reference(
        one, EVICT, service=ref_sweep.ServiceParams(**SMALL_CACHE))


def test_blocks_match_reference():
    assert_matches_reference(closed(UNEVEN, 3), UNEVEN)


@pytest.mark.parametrize("max_rounds", [2, 200])
def test_padded_blocks_bitwise_on_reference_shards(max_rounds):
    """The reference's own padded shards (``_closed_assemble`` +
    ``_closed_pad`` to the common shape, as its sharded program gets
    them), each through the reference's round program and, together, the
    port's lockstep fixed point: completions, start times, pieces,
    convergence and rounds bitwise equal per block."""
    pts = [ref_sweep.SweepPoint(**asdict(p)) for p in UNEVEN]
    dm = ref_sweep._DelayModel(ref_sweep.SETTINGS["edge"],
                               ref_sweep.ServiceParams())
    built = [ref_sweep._closed_point_build(p, 0, dm, 2500, 1) for p in pts]
    D = 4
    blks = [ref_sweep._closed_assemble(built[d::D]) for d in range(D)]
    n_max = max(b["n"] for b in blks)
    R = max(len(b["rows"]) for b in blks)
    Ls = max(len(m) for b in blks for m in b["rows"])
    padded = [ref_sweep._closed_pad(b, n_max, R, Ls) for b in blks]
    g = dict(max_hops=max(b["max_hops"] for b in built),
             seek=float(dm.seek), R=R, Ls=Ls)
    run = jax.jit(ref_sweep._closed_round_fn(
        g["max_hops"], "seq", True, max_rounds, g["seek"], R, Ls))
    got = sweep._closed_fixed_point(
        [(sweep.to_device(f, "cpu"), sweep.to_device(a, "cpu"))
         for f, a in padded], scan_backend="seq", max_rounds=max_rounds,
        **g)
    for (flat, aux), (comp, t0, done, rounds, pieces) in zip(padded, got):
        with jax.enable_x64():
            w = jax.device_get(run(
                {k: jnp.asarray(v) for k, v in flat.items()},
                {k: jnp.asarray(v) for k, v in aux.items()}))
        assert np.array_equal(comp.numpy(), w[0])
        assert np.array_equal(t0.numpy(), w[1])
        assert np.array_equal(pieces.numpy(), w[4])
        assert (done, rounds) == (bool(w[2]), int(w[3]))


@pytest.fixture
def two_gpus(monkeypatch):
    """The CUDA queries of a host with two GPUs, current device 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


@pytest.mark.parametrize("device,devices", [("cuda", 3), ("cuda:0", 3),
                                            ("cuda:1", 2), (None, 8)])
def test_cuda_devices_past_the_visible_ones_raise(two_gpus, device,
                                                  devices):
    with pytest.raises(ValueError, match="only 2 CUDA devices visible"):
        run_sweep(GRID, loop="closed", devices=devices, device=device)


def test_cuda_block_devices(two_gpus):
    cuda = torch.device("cuda")
    assert sweep._block_devices(cuda, 2, 2) == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    # fewer points than devices: fewer blocks, still one GPU each
    assert sweep._block_devices(cuda, 2, 1) == [torch.device("cuda", 0)]
    assert sweep._block_devices(torch.device("cuda", 1), 1, 1) == [
        torch.device("cuda", 1)]
    assert sweep._block_devices(torch.device("cpu"), 8, 3) == [
        torch.device("cpu")] * 3


def test_cuda_eviction_regime_does_not_check_devices(two_gpus):
    """With eviction the host path runs whatever ``devices`` says, as in
    the reference, so ``devices=8`` on two GPUs does not raise."""
    res = run_sweep(EVICT, loop="closed", devices=8, device="cuda",
                    service=ServiceParams(**SMALL_CACHE))
    assert res.info["rounds"] is None
    assert_bitwise(res, closed(EVICT, 1,
                               service=ServiceParams(**SMALL_CACHE)))
