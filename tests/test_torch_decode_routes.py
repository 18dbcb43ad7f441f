"""The decode step's (K3) routes and the arithmetic of its ``sm90`` kernel,
on the CPU.

* ``lasp2_decode._route`` is a fixed table: dk a multiple of 16 up to 256
  and dv a multiple of 4 go to ``csrc/lasp2_decode_sm90.cu`` (``sm90``),
  for bf16 and fp32 alike; every other shape to the CUDA-core kernel
  (``simt``). CPU tensors run the plain version and move no launch
  counter.
* ``sm90_decode_emulation`` transcribes the ``sm90`` kernel's arithmetic:
  16-column slices (the last one narrower), M' = fma(a, M, k_r·v_j) in
  fp32, each thread's sum of q_r·M'_r over its rows r = g, g + R, ... in
  row order (R = min(dk, 32) row groups), then the groups' sums in the
  kernel's fixed order: a warp's eight groups as a tree (pairs, pairs of
  pairs, the halves), then the warps in order. Over 8 chained steps from a
  prefill state it meets the card's limits against
  ``lasp2_decode_step_plain`` and against the reference's Pallas
  ``lasp2_decode_step`` in interpret mode: o within 3e-4, state 1e-4, log
  decay 1e-5 (absolute + relative).
* ``linear_decode_op(log_a=None)`` equals ``log_a = zeros`` and the
  reference's ``linear_decode_op``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.lasp2_decode import lasp2_decode_step as j_decode_step
from repro_torch.core.linear_attention import RESET_LOG_A
from repro_torch.kernels import lasp2_decode as ld_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels.lasp2_chunk import lasp2_chunk_fwd_plain

COLS = 16           # columns of M a block of the sm90 kernel owns
TOL_O, TOL_STATE, TOL_LD = 3e-4, 1e-4, 1e-5
SHAPES = [(16, 16), (64, 128), (128, 64), (128, 128), (32, 200), (16, 64),
          (16, 260)]


@pytest.mark.parametrize("dtype,dk,dv,route", [
    (torch.bfloat16, 128, 128, "sm90"), (torch.float32, 128, 128, "sm90"),
    (torch.bfloat16, 64, 64, "sm90"), (torch.bfloat16, 128, 64, "sm90"),
    (torch.bfloat16, 16, 64, "sm90"), (torch.float32, 32, 200, "sm90"),
    (torch.bfloat16, 256, 128, "sm90"), (torch.bfloat16, 16, 4, "sm90"),
    (torch.float32, 128, 256, "sm90"), (torch.bfloat16, 128, 260, "sm90"),
    (torch.bfloat16, 272, 128, "simt"), (torch.bfloat16, 128, 30, "simt"),
    (torch.float32, 64, 2, "simt"), (torch.float16, 128, 128, "simt")])
def test_route_table(dtype, dk, dv, route):
    assert ld_mod._route(dtype, dk, dv) == route
    assert route in ld_mod.ROUTES


@pytest.mark.parametrize("with_log_a", [True, False])
def test_cpu_tensors_take_the_plain_version(with_log_a):
    """On the CPU the wrapper runs ``recurrent_step``: new tensors, no
    launch counter (total or per route) moves."""
    q, k, v, la, st, ld = _step_inputs(np.random.default_rng(0), 3, 64, 64,
                                       "float32")
    before = (ld_mod.lasp2_decode_step.launches,
              dict(ld_mod.lasp2_decode_step.route_launches))
    la = la if with_log_a else None
    o, st2, ld2 = ld_mod.lasp2_decode_step(q, k, v, la, st, ld)
    o_p, st_p, ld_p = ld_mod.lasp2_decode_step_plain(q, k, v, la, st, ld)
    assert (ld_mod.lasp2_decode_step.launches,
            dict(ld_mod.lasp2_decode_step.route_launches)) == before
    assert torch.equal(o, o_p) and torch.equal(st2, st_p) \
        and torch.equal(ld2, ld_p)
    assert st2.data_ptr() != st.data_ptr()
    if not with_log_a:
        assert torch.equal(ld2, ld)


def test_wrapper_checks_shapes_and_devices_on_the_cpu():
    q, k, v, la, st, ld = _step_inputs(np.random.default_rng(1), 2, 16, 16,
                                       "float32")
    with pytest.raises(ValueError, match="want q, k"):
        ld_mod.lasp2_decode_step(q, k, v[:, :8], la, st, ld)
    with pytest.raises(ValueError, match="want q, k"):
        ld_mod.lasp2_decode_step(q, k, v, la[:1], st, ld)
    with pytest.raises(ValueError, match="several devices"):
        ld_mod.lasp2_decode_step(q, k, v, la, st, ld.to("meta"))


# ---------------------------------------------------------------------------
# The sm90 kernel's arithmetic.
# ---------------------------------------------------------------------------

def _f32(x):
    return x.to(torch.float32)


def _fma(a, b, c):
    """fp32 fmaf(a, b, c): the exact product and sum (float64 holds the
    product of two fp32 values exactly) rounded once to fp32."""
    return _f32(a.double() * b.double() + c.double())


def sm90_decode_emulation(q, k, v, log_a, state, log_decay):
    """The ``sm90`` kernel's arithmetic on the CPU, slice by slice. Returns
    (o, state', log_decay') in fp32."""
    bh, dk = q.shape
    dv = v.shape[1]
    groups = min(dk, 32)                  # R: threads of a column quad
    qf, kf, vf = _f32(q), _f32(k), _f32(v)
    a = torch.ones(bh) if log_a is None else torch.exp(log_a)
    m_new = torch.empty(bh, dk, dv)
    o = torch.empty(bh, dv)
    for j0 in range(0, dv, COLS):
        cols = slice(j0, min(dv, j0 + COLS))
        m = state[:, :, cols]
        kv = _f32(kf[:, :, None] * vf[:, None, cols])   # k_r·v_j in fp32
        mn = _fma(a[:, None, None].expand_as(m), m, kv)
        m_new[:, :, cols] = mn
        # each thread's sum over its rows, in row order
        acc = torch.zeros(bh, groups, mn.shape[-1])
        for r0 in range(0, dk, groups):
            g = min(groups, dk - r0)
            acc[:, :g] = _fma(qf[:, r0:r0 + g, None].expand(-1, -1,
                                                            mn.shape[-1]),
                              mn[:, r0:r0 + g], acc[:, :g])
        # a warp's eight groups: pairs (xor 4), pairs of pairs (xor 8), the
        # halves (xor 16); then the warps in order
        w = acc.reshape(bh, groups // 8, 8, -1)
        for _ in range(3):
            w = _f32(w[:, :, 0::2] + w[:, :, 1::2])
        warp = w[:, :, 0]
        s = warp[:, 0]
        for i in range(1, groups // 8):
            s = _f32(s + warp[:, i])
        o[:, cols] = s
    ld = log_decay if log_a is None else _f32(log_decay + log_a)
    return o, m_new, ld


def _step_inputs(rng, bh, dk, dv, dtype, with_state=True):
    """One step's q, k, v in ``dtype`` (from numpy), log a fp32, and a
    random fp32 state and log decay."""
    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    q, k = randn(bh, dk, scale=0.3), randn(bh, dk, scale=0.3)
    v = randn(bh, dv, scale=0.5)
    q, k, v = (x.to(getattr(torch, dtype)) for x in (q, k, v))
    la = -torch.from_numpy(rng.random(bh).astype(np.float32)) * 0.05
    st = randn(bh, dk, dv) if with_state else None
    ld = -torch.from_numpy(rng.random(bh).astype(np.float32))
    return q, k, v, la, st, ld


def _prefill_state(rng, bh, dk, dv, dtype):
    """State and log decay after a 37-token prefill with resets, as the
    chunk forward (K1) hands them to decode."""
    def randn(*shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(
                getattr(torch, dtype))
    s = 37
    q, k = randn(bh, s, dk, scale=0.3), randn(bh, s, dk, scale=0.3)
    v = randn(bh, s, dv, scale=0.5)
    la = -torch.from_numpy(rng.random((bh, s)).astype(np.float32)) * 0.05
    la[:, [5, 20]] = RESET_LOG_A
    _, st, ld = lasp2_chunk_fwd_plain(q, k, v, la, block_size=s)
    return st, ld


def _within(got, want, tol):
    """|got - want| <= tol + tol·|want| everywhere (the card's limits)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= tol + tol * np.abs(want)))


@pytest.mark.parametrize("dk,dv", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sm90_emulation_meets_limits_over_8_steps(dk, dv, dtype):
    """8 chained steps from a prefill state, one of them a reset for half
    the rows: the emulation against the plain version and against the
    reference's Pallas kernel in interpret mode, at the card's limits."""
    rng = np.random.default_rng(dk * 1000 + dv)
    bh = 6
    st0, ld0 = _prefill_state(rng, bh, dk, dv, dtype)
    st_e, ld_e = st0.clone(), ld0.clone()
    st_p, ld_p = st0.clone(), ld0.clone()
    st_j, ld_j = jnp.asarray(st0.numpy()), jnp.asarray(ld0.numpy())
    for step in range(8):
        q, k, v, la, _, _ = _step_inputs(rng, bh, dk, dv, dtype,
                                         with_state=False)
        if step == 3:
            la[: bh // 2] = RESET_LOG_A
        o_e, st_e, ld_e = sm90_decode_emulation(q, k, v, la, st_e, ld_e)
        o_p, st_p, ld_p = ld_mod.lasp2_decode_step_plain(q, k, v, la, st_p,
                                                         ld_p)
        o_j, st_j, ld_j = j_decode_step(
            *(jnp.asarray(x.float().numpy()).astype(dtype)
              for x in (q, k, v)),
            jnp.asarray(la.numpy()), st_j, ld_j, interpret=True)
        assert _within(o_e, o_p, TOL_O), f"o vs plain, step {step}"
        assert _within(o_e, o_j, TOL_O), f"o vs Pallas, step {step}"
    for want_st, want_ld, what in ((st_p, ld_p, "plain"),
                                   (st_j, ld_j, "Pallas")):
        assert _within(st_e, want_st, TOL_STATE), f"state vs {what}"
        assert _within(ld_e, want_ld, TOL_LD), f"log decay vs {what}"


@pytest.mark.parametrize("dk,dv", [(128, 128), (32, 200), (16, 64)])
def test_sm90_emulation_without_log_a_leaves_the_decay(dk, dv):
    """A null log a is a = 1: the emulation equals the plain version with
    ``log_a=None`` and with zeros, and leaves log decay as it was."""
    rng = np.random.default_rng(7)
    q, k, v, _, st, ld = _step_inputs(rng, 4, dk, dv, "bfloat16")
    o_e, st_e, ld_e = sm90_decode_emulation(q, k, v, None, st, ld)
    o_z, st_z, ld_z = sm90_decode_emulation(q, k, v, torch.zeros(4), st, ld)
    o_p, st_p, ld_p = ld_mod.lasp2_decode_step_plain(q, k, v, None, st, ld)
    assert torch.equal(o_e, o_z) and torch.equal(st_e, st_z)
    assert torch.equal(ld_e, ld) and torch.equal(ld_z, ld)
    assert _within(o_e, o_p, TOL_O) and _within(st_e, st_p, TOL_STATE)
    assert torch.equal(ld_p, ld)


def test_emulation_sum_order_is_the_kernels_not_the_plain_ones():
    """The emulation's o is not the plain version's bit for bit at the
    serving width (the fixed order of the kernel's sums differs from
    einsum's), yet within the limit: the check above is not vacuous."""
    rng = np.random.default_rng(3)
    q, k, v, la, st, ld = _step_inputs(rng, 8, 128, 128, "float32")
    o_e, st_e, _ = sm90_decode_emulation(q, k, v, la, st, ld)
    o_p, st_p, _ = ld_mod.lasp2_decode_step_plain(q, k, v, la, st, ld)
    assert not torch.equal(o_e, o_p)
    assert _within(o_e, o_p, TOL_O) and _within(st_e, st_p, TOL_STATE)


# ---------------------------------------------------------------------------
# linear_decode_op without log a.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dk,dv", [(16, 16), (32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_decode_op_without_log_a(dk, dv, dtype):
    """``log_a=None`` gives what ``log_a = zeros`` gives, bit for bit, and
    agrees with the reference's op (which makes the zeros itself) run
    through its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(11)
    b, h = 2, 3
    q, k, v, _, st, ld = _step_inputs(rng, b * h, dk, dv, dtype)
    q, k, v = (x.reshape(b, h, -1) for x in (q, k, v))
    st, ld = st.reshape(b, h, dk, dv), ld.reshape(b, h)
    o_n, st_n, ld_n = tops.linear_decode_op(q, k, v, None, st, ld)
    o_z, st_z, ld_z = tops.linear_decode_op(q, k, v, torch.zeros(b, h), st,
                                            ld)
    assert torch.equal(o_n, o_z) and torch.equal(st_n, st_z) \
        and torch.equal(ld_n, ld_z)
    jo, jst, jld = jops.linear_decode_op(
        *(jnp.asarray(x.float().numpy()).astype(dtype) for x in (q, k, v)),
        None, jnp.asarray(st.numpy()), jnp.asarray(ld.numpy()),
        backend="interpret")
    assert _within(o_n, jo, TOL_O) and _within(st_n, jst, TOL_STATE)
    assert _within(ld_n, jld, TOL_LD)
