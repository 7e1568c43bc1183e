"""The SSD scan and the xLSTM blocks in the PyTorch port against the JAX
reference on the same seeded numpy inputs.  CPU tensors run the scan's
plain versions; the CUDA kernel itself is tested in
``test_torch_kernels_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models import ssm as jssm
from repro_torch.kernels.ssm_scan import (ssd_chunked_ref, ssd_ref, ssm_scan,
                                          ssm_scan_kernel)
from repro_torch.models import ssm as tssm

TOL = 1e-4   # the reference kernel tests' rtol/atol


def folded_inputs(BH, S, P, N, seed, decay=None):
    """The reference kernel tests' distributions (normal x, log decay
    -softplus, sigmoid step, B/C scaled by 1/sqrt(N)), drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P))
    loga = (-np.logaddexp(0.0, rng.standard_normal((BH, S, 1)))
            if decay is None else np.full((BH, S, 1), decay))
    dt = 1.0 / (1.0 + np.exp(-rng.standard_normal((BH, S, 1))))
    Bm = rng.standard_normal((BH, S, N)) / np.sqrt(N)
    Cm = rng.standard_normal((BH, S, N)) / np.sqrt(N)
    return [a.astype(np.float32) for a in (x, loga, dt, Bm, Cm)]


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


# tests/test_kernels_ssm.py's four cases
CASES = [(32, 8, 16, 8), (64, 16, 8, 16), (16, 16, 32, 8), (48, 8, 16, 16)]


@pytest.mark.parametrize("S,chunk,P,N", CASES)
def test_plain_versions_match_pallas_interpret(S, chunk, P, N):
    arrs = folded_inputs(3, S, P, N, S + P + N)
    want = jax_ssm_scan(*map(jnp.asarray, arrs), chunk=chunk,
                        use_pallas=True, interpret=True)
    close(ssd_chunked_ref(*map(t, arrs), chunk=chunk)[0], want)
    close(ssd_ref(*map(t, arrs))[0], want)
    close(ssm_scan(*map(t, arrs), chunk=chunk)[0], want)


@pytest.mark.parametrize("S,chunk", [(16, 4), (32, 8), (24, 8), (8, 8)])
def test_h0_and_h_final_match_ssd_chunked(S, chunk):
    """Multi-head layout with B/C shared across heads, from a random
    initial state: y and the final state against the reference's
    ``ssd_chunked`` and ``ssd_ref``."""
    rng = np.random.default_rng(S * chunk)
    B, H, P, N = 2, 3, 8, 4
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    loga = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(
        np.float32)
    dt = (1 / (1 + np.exp(-rng.standard_normal((B, S, H))))).astype(
        np.float32)
    Bm = (rng.standard_normal((B, S, N)) / 2).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) / 2).astype(np.float32)
    h0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    arrs = (x, loga, dt, Bm, Cm)
    for state in (None, h0):
        jy, jh = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk,
                                  h0=None if state is None
                                  else jnp.asarray(state))
        ty, th = tssm.ssd_chunked(*map(t, arrs), chunk=chunk,
                                  h0=None if state is None else t(state))
        close(ty, jy)
        close(th, jh)
        ry, rh = jssm.ssd_ref(*map(jnp.asarray, arrs),
                              h0=None if state is None
                              else jnp.asarray(state))
        sy, sh = tssm.ssd_ref(*map(t, arrs),
                              h0=None if state is None else t(state))
        close(sy, ry)
        close(sh, rh)


def test_strong_decay_stays_finite():
    """60 nats a token: within a 128-token chunk exp(cum_t - cum_s) above
    the diagonal overflows to inf.  The plain version selects, so no
    inf * 0 = nan, and with no history left y is C_t . B_t x_t dt_t."""
    x, loga, dt, Bm, Cm = folded_inputs(2, 256, 16, 8, 3, decay=-60.0)
    y, h = ssm_scan(*map(t, (x, loga, dt, Bm, Cm)), chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    close(y, np.einsum("bsd,bsd,bsp->bsp", Cm, Bm, x * dt))
    want = jax_ssm_scan(*map(jnp.asarray, (x, loga, dt, Bm, Cm)),
                        chunk=128, use_pallas=False)
    close(y, want)


def test_plain_versions_sum_float64_inputs_in_float64():
    """Float64 inputs keep float64 sums and state (the oracle the GPU
    kernel's float32 accuracy is measured against): the chunked and the
    sequential forms agree far below float32's rounding, and the
    float32 run lands within float32's own error of them."""
    arrs = folded_inputs(2, 64, 8, 16, 9)
    h0 = np.random.default_rng(10).standard_normal((2, 16, 8))
    f64 = [t(a).double() for a in arrs]
    y, h = ssd_chunked_ref(*f64, chunk=16, h0=t(h0))
    ry, rh = ssd_ref(*f64, h0=t(h0))
    assert y.dtype == h.dtype == torch.float64
    close(y, ry, 1e-12)
    close(h, rh, 1e-12)
    y32, h32 = ssd_chunked_ref(*map(t, arrs), chunk=16, h0=t(h0).float())
    assert y32.dtype == h32.dtype == torch.float32
    err = float((y32.double() - y).abs().max())
    assert 0 < err < 1e-5, err


def test_rows_do_not_share_state():
    """Permuting rows permutes outputs (tests/test_kernels_ssm.py)."""
    arrs = folded_inputs(4, 16, 8, 4, 2)
    out = ssm_scan(*map(t, arrs), chunk=8)[0]
    perm = [2, 0, 3, 1]
    out_p = ssm_scan(*(t(a[perm]) for a in arrs), chunk=8)[0]
    close(out_p, out[perm], 1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    """Only ``ssm_scan`` sends CPU tensors to the plain version; the
    kernel's own wrapper raises on them and counts no launch."""
    arrs = folded_inputs(2, 16, 8, 4, 1)
    before = ssm_scan_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_kernel(*map(t, arrs), chunk=8)
    assert ssm_scan_kernel.launches == before


def mlstm_case(seed, B=2, S=24, D=16, nh=4):
    p = jssm.mlstm_init(jax.random.PRNGKey(seed), D, nh)
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    return {k: np.asarray(v) for k, v in p.items()}, x


def random_state(rng, shapes):
    return {k: (np.abs(rng.standard_normal(s)) + (1.0 if k == "n" else 0.0)
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [24, 1])
def test_mlstm_apply_matches_jax(with_state, S):
    B, D, nh = 2, 16, 4
    p, x = mlstm_case(5, B=B, S=S, D=D, nh=nh)
    hd = 2 * D // nh
    state = None
    if with_state:
        state = random_state(np.random.default_rng(6), {
            "num": (B * nh, 1, hd, hd), "den": (B * nh, 1, hd, 1)})
    jy, jst = jssm.mlstm_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), nh,
        chunk=8, state=None if state is None
        else {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = tssm.mlstm_apply(
        {k: t(v) for k, v in p.items()}, t(x), nh, chunk=8,
        state=None if state is None else {k: t(v) for k, v in state.items()})
    close(ty, jy)
    assert (tst is None) == (jst is None)
    if jst is not None:
        for k in ("num", "den"):
            close(tst[k], jst[k])


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_apply_matches_jax(with_state):
    B, S, D = 2, 12, 16
    p = {k: np.asarray(v)
         for k, v in jssm.slstm_init(jax.random.PRNGKey(3), D).items()}
    x = np.random.default_rng(4).standard_normal((B, S, D)).astype(
        np.float32)
    state = (random_state(np.random.default_rng(7),
                          {g: (B, D) for g in "hcn"}) if with_state else None)
    jy, jst = jssm.slstm_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        state=None if state is None
        else {k: jnp.asarray(v) for k, v in state.items()})
    ty, tst = tssm.slstm_apply(
        {k: t(v) for k, v in p.items()}, t(x),
        state=None if state is None else {k: t(v) for k, v in state.items()})
    close(ty, jy)
    if with_state:
        for g in "hcn":
            close(tst[g], jst[g])
