"""The kernels' shapes, on the CPU: every width the Pallas kernels take.

The reference's Pallas kernels load a whole dk, dv or dh per block and
check nothing but the sequence tiling, so they take the head widths of
every config: SMOKE's 16 (and qwen1.5-110b SMOKE's softmax heads of 8),
Table 2's llama3-tiny heads of 32, and the taylor feature map's key width
1 + dh + dh² (1057 at dh 32, 16513 at dh 128). The port's ``simt`` kernels
take them too: K1, K2a and K2b any dk and dv (ragged last tiles; K1 and
K2b split dk past ``DK_SLICE`` rows into slices and reduce the slices'
partial sums in a second kernel), K3 any dk up to ``SIMT_MAX_DK``, K4, K5a
and K5b any dh up to 128 (zero-filled to the next built width). Here:

* the port's plain versions, which the card's kernels are held to,
  against the reference's Pallas kernels in interpret mode (as
  ``tests/test_kernels.py`` runs them) at (dk, dv) = (16, 16), (32, 32)
  and (1057, 32), S 128: K1's o, state and log decay; K2's dq, dk, dv and
  dlog_a through the reference's ``custom_vjp``; K3's o and state over
  three chained steps; K4's o and lse and K5's dq, dk and dv at dh 8 and
  32 (causal, windowed, GQA 4:1, ragged Sq and Sk);
* a transcription of K1's and K2b's dk split (128-row slices, each
  slice's partial o, dv and rowsum(K ⊙ dk) over 64-row chunks, reduced in
  slice order, dlog_a's suffix sum over r after the reduction) against
  the plain versions at dk 1057;
* the route tables (every new shape to ``simt``, the ``sm90`` shapes as
  they were) and the wrappers' device-free refusal predicates: which
  shapes the card launches and which it refuses, with which message;
* Table 2's ``llama3-tiny`` (4 layers, d 128, 4 heads of 32, d_ff 352,
  vocab 2048) as ``based`` (taylor, dk 1057) and as the basic 1/4 hybrid:
  logits and every parameter gradient against the reference.

Tolerances: the reference's (``tests/test_kernels.py:14-15``), fp32 3e-4
for outputs and states, 1e-3 for gradients; log decays 1e-5. Inputs come
from a numpy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.kernels import flash_attention as jflash
from repro.kernels import lasp2_chunk as jchunk
from repro.kernels import lasp2_decode as jdecode
from repro.kernels import ops as jops
from repro.models import model as JM
from repro_torch.configs import base as TB
from repro_torch.core.linear_attention import RESET_LOG_A
from repro_torch.core.tree import leaves_with_paths, tree_map
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import lasp2_chunk as lc
from repro_torch.kernels import lasp2_decode as ldm
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from test_torch_variants import _close_trees, _port

TOL, GRAD_TOL, LD_TOL = 3e-4, 1e-3, 1e-5
CHUNK_SHAPES = [(16, 16), (32, 32), (1057, 32)]
S = 128
CHUNK = 64          # rows per chunk of the simt kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is fastest beside the suite's
    parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(np.asarray(t.detach().float()),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


def _chunk_case(seed, bh, s, dk, dv):
    """q, k (scaled as the feature maps leave them), v, a decaying log a
    with a reset mid-chunk, and cotangents for o and the state."""
    rng = np.random.default_rng(seed)
    qk_scale = 0.3 / np.sqrt(max(dk / 32, 1.0))
    q = (rng.standard_normal((bh, s, dk)) * qk_scale).astype(np.float32)
    k = (rng.standard_normal((bh, s, dk)) * qk_scale).astype(np.float32)
    v = (rng.standard_normal((bh, s, dv)) * 0.5).astype(np.float32)
    la = (-np.abs(rng.standard_normal((bh, s))) * 0.03).astype(np.float32)
    la[:, s // 2 - 7] = RESET_LOG_A
    do = rng.standard_normal((bh, s, dv)).astype(np.float32)
    dst = (rng.standard_normal((bh, dk, dv)) * 0.1).astype(np.float32)
    return q, k, v, la, do, dst


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels in interpret mode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dk,dv", CHUNK_SHAPES)
def test_chunk_fwd_plain_matches_pallas(dk, dv):
    """K1: o, the end state and the log decay."""
    q, k, v, la, _, _ = _chunk_case(0, 2, S, dk, dv)
    jo, jst, jld = jchunk.lasp2_chunk_fwd(
        *(jnp.asarray(x) for x in (q, k, v, la)), block_size=64,
        interpret=True)
    o, st, ld = lc.lasp2_chunk_fwd(*(torch.from_numpy(x)
                                     for x in (q, k, v, la)), block_size=64)
    _close(o, jo, TOL, "o")
    _close(st, jst, TOL, "state")
    _close(ld, jld, LD_TOL, "log decay")


@pytest.mark.parametrize("dk,dv", CHUNK_SHAPES)
def test_chunk_grads_match_pallas_custom_vjp(dk, dv):
    """K2a and K2b through the reference's ``custom_vjp`` (both backward
    Pallas passes in interpret mode) against ``LASP2Chunk`` on the plain
    passes, with cotangents on o, the state and the log decay."""
    q, k, v, la, do, dst = _chunk_case(1, 2, S, dk, dv)
    dld = np.linspace(-0.5, 0.5, 2).astype(np.float32)

    def jloss(a, b, c, d):
        o, st, ld = jchunk.lasp2_chunk(a, b, c, d, 64, True)
        return jnp.sum(o * do) + jnp.sum(st * dst) + jnp.sum(ld * dld)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, la)))
    leaves = [torch.from_numpy(x).requires_grad_(True)
              for x in (q, k, v, la)]
    o, st, ld = lc.LASP2Chunk.apply(*leaves, 64)
    loss = (o * torch.from_numpy(do)).sum() \
        + (st * torch.from_numpy(dst)).sum() \
        + (ld * torch.from_numpy(dld)).sum()
    tg = torch.autograd.grad(loss, leaves)
    for name, t, j in zip(("dq", "dk", "dv", "dlog_a"), tg, jg):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        _close(t / scale, np.asarray(j) / scale, GRAD_TOL, name)


@pytest.mark.parametrize("dk,dv", CHUNK_SHAPES)
def test_decode_plain_matches_pallas(dk, dv):
    """K3: three chained steps from a nonzero state, o and the state."""
    rng = np.random.default_rng(2)
    bh = 3
    st = (rng.standard_normal((bh, dk, dv)) * 0.1).astype(np.float32)
    ld = -np.abs(rng.standard_normal(bh)).astype(np.float32)
    jst, jld = jnp.asarray(st), jnp.asarray(ld)
    tst, tld = torch.from_numpy(st), torch.from_numpy(ld)
    for _ in range(3):
        q, k = ((rng.standard_normal((bh, dk)) * 0.3).astype(np.float32)
                for _ in range(2))
        v = (rng.standard_normal((bh, dv)) * 0.5).astype(np.float32)
        la = (-np.abs(rng.standard_normal(bh)) * 0.1).astype(np.float32)
        jo, jst, jld = jdecode.lasp2_decode_step(
            *(jnp.asarray(x) for x in (q, k, v, la)), jst, jld,
            interpret=True)
        to, tst, tld = ldm.lasp2_decode_step(
            *(torch.from_numpy(x) for x in (q, k, v, la)), tst, tld)
        _close(to, jo, TOL, "o")
    _close(tst, jst, TOL, "state")
    _close(tld, jld, LD_TOL, "log decay")


def _flash_case(seed, b, hq, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, sq, dh)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((b, hkv, sk, dh)) * 0.4).astype(np.float32)
    v = (rng.standard_normal((b, hkv, sk, dh)) * 0.5).astype(np.float32)
    co = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    return q, k, v, co


@pytest.mark.parametrize("dh", [8, 32])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window", [
    (4, 4, 128, 128, True, None), (4, 1, 64, 192, True, 48),
    (4, 2, 128, 128, False, None)])
def test_flash_fwd_plain_matches_pallas(dh, hq, hkv, sq, sk, causal,
                                        window):
    """K4's o and lse against the reference's ``_fwd_call``: causal, a
    window over Sq < Sk with GQA 4:1, bidirectional GQA 2:1."""
    q, k, v, _ = _flash_case(3, 2, hq, hkv, sq, sk, dh)
    off = sk - sq
    jo, jlse = jflash._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.full((1, 1), off, jnp.int32), causal=causal,
        sliding_window=window, scale=dh ** -0.5, q_offset=off, kv_len=sk,
        block_q=64, block_k=64, interpret=True)
    o, lse = fl.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                    causal=causal, window=window)
    _close(o, jo, TOL, "o")
    _close(lse, jlse, TOL, "lse")


@pytest.mark.parametrize("dh", [8, 32])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window", [
    (4, 1, 100, 100, True, None), (4, 4, 72, 136, True, 48),
    (4, 2, 100, 100, False, None)])
def test_flash_grads_match_pallas_custom_vjp(dh, hq, hkv, sq, sk, causal,
                                             window):
    """K5a's dq and K5b's dk, dv through the reference's ``custom_vjp``
    (its op pads ragged Sq and Sk to the block) against
    ``ops.flash_attention_op`` on the plain versions."""
    q, k, v, co = _flash_case(4, 2, hq, hkv, sq, sk, dh)
    jco = jnp.asarray(co)

    def jloss(a, b, c):
        o = jops.flash_attention_op(a, b, c, causal=causal,
                                    sliding_window=window,
                                    backend="interpret", block_q=64,
                                    block_k=64)
        return jnp.sum(o * jco)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tops.flash_attention_op(*leaves, causal=causal,
                                sliding_window=window)
    tg = torch.autograd.grad((o * torch.from_numpy(co)).sum(), leaves)
    for name, t, j in zip(("dq", "dk", "dv"), tg, jg):
        _close(t, j, GRAD_TOL, name)


# ---------------------------------------------------------------------------
# The dk split, transcribed.
# ---------------------------------------------------------------------------

def _slices(dk):
    return [slice(t * lc.DK_SLICE, min(dk, (t + 1) * lc.DK_SLICE))
            for t in range(lc.dk_slices(dk))]


def _chunks(s):
    return [slice(c * CHUNK, min(s, (c + 1) * CHUNK))
            for c in range(-(-s // CHUNK))]


def split_fwd_emulation(q, k, v, la):
    """K1 past one slice: each dk slice carries its rows M_t of the state
    over 64-row chunks and writes its partial o, (Q_t K_tᵀ ⊙ D) V +
    (Q_t ⊙ e^{cb}) M_t, in fp32; the reduction sums the partials in slice
    order. Returns (o, state, log decay)."""
    bh, s, dk = q.shape
    parts, states = [], []
    for sl in _slices(dk):
        m = torch.zeros(bh, sl.stop - sl.start, v.shape[-1])
        part = []
        for rows in _chunks(s):
            qb, kb, vb = q[:, rows, sl], k[:, rows, sl], v[:, rows]
            cb = torch.cumsum(la[:, rows], dim=-1)
            a = cb[:, -1:]
            part.append((qb @ kb.transpose(1, 2)) * lc._decay_mat(cb) @ vb
                        + torch.exp(cb)[..., None] * (qb @ m))
            m = torch.exp(a)[..., None] * m \
                + (kb * torch.exp(a - cb)[..., None]).transpose(1, 2) @ vb
        parts.append(torch.cat(part, dim=1))
        states.append(m)
    o = parts[0]
    for p in parts[1:]:
        o = o + p
    return o, torch.cat(states, dim=1), la.sum(-1)


def split_dkv_emulation(q, k, v, la, o, do, dst):
    """K2b past one slice: each dk slice carries its rows N_t of the
    suffix state gradient, last chunk first, writes its dk columns and its
    partial dv and rowsum(K_t ⊙ dk_t) in fp32; the reduction sums those in
    slice order, forms r = rowsum(dO ⊙ o) − rowsum(K ⊙ dk) and takes
    dlog_a's suffix sum over r, last chunk first. Returns (dk, dv, dla)."""
    bh, s, dk = q.shape
    dv_parts, rk_parts, dks = [], [], []
    for sl in _slices(dk):
        n = dst[:, sl]
        dk_t = torch.zeros(bh, s, sl.stop - sl.start)
        dv_t = torch.zeros(bh, s, v.shape[-1])
        rk_t = torch.zeros(bh, s)
        for rows in reversed(_chunks(s)):
            qb, kb, vb, dob = q[:, rows, sl], k[:, rows, sl], v[:, rows], \
                do[:, rows]
            cb = torch.cumsum(la[:, rows], dim=-1)
            a = cb[:, -1:]
            dmat = lc._decay_mat(cb)
            w = torch.exp(a - cb)[..., None]
            dsc = (dob @ vb.transpose(1, 2)) * dmat
            g = dsc.transpose(1, 2) @ qb + w * (vb @ n.transpose(1, 2))
            sc = (qb @ kb.transpose(1, 2)) * dmat
            dv_t[:, rows] = sc.transpose(1, 2) @ dob + w * (kb @ n)
            dk_t[:, rows] = g
            rk_t[:, rows] = (kb * g).sum(-1)
            n = torch.exp(a)[..., None] * n \
                + (qb * torch.exp(cb)[..., None]).transpose(1, 2) @ dob
        dks.append(dk_t)
        dv_parts.append(dv_t)
        rk_parts.append(rk_t)
    dv_out, rk = dv_parts[0], rk_parts[0]
    for dv_t, rk_t in zip(dv_parts[1:], rk_parts[1:]):
        dv_out, rk = dv_out + dv_t, rk + rk_t
    r = (do * o).sum(-1) - rk
    dla = torch.zeros(bh, s)
    rsum = torch.zeros(bh, 1)
    for rows in reversed(_chunks(s)):
        rr = r[:, rows]
        dla[:, rows] = torch.flip(torch.cumsum(torch.flip(rr, [1]), 1),
                                  [1]) + rsum
        rsum = rsum + rr.sum(-1, keepdim=True)
    return torch.cat(dks, dim=2), dv_out, dla


@pytest.mark.parametrize("dk,slices", [(16, 1), (128, 1), (129, 2),
                                       (1057, 9), (16513, 130)])
def test_dk_slices(dk, slices):
    assert lc.dk_slices(dk) == slices


@pytest.mark.parametrize("kernel,dk,dv", [("K1", 128, 32), ("K1", 129, 50),
                                          ("K1", 16513, 128),
                                          ("K2b", 128, 32), ("K2b", 129, 50),
                                          ("K2b", 1057, 32)])
def test_workspace_holds_every_slice(kernel, dk, dv):
    """One slice takes no workspace; past it the workspace holds exactly
    the slices K1 and K2b split dk into, the count their C entries are
    told and check."""
    bh, s = 3, 70
    shape = lc.workspace(kernel, bh, s, dk, dv)
    if lc.dk_slices(dk) == 1:
        assert shape is None and lc._work_slices(kernel, None, bh, s, dv) == 0
        return
    work = torch.empty(shape)
    assert work.numel() == lc.dk_slices(dk) * bh * s * (dv + (kernel == "K2b"))
    assert lc._work_slices(kernel, work, bh, s, dv) == lc.dk_slices(dk)


def test_split_transcriptions_match_the_plain_versions():
    """At dk 1057 (9 slices, the last of 33 rows) and S 200 (a ragged last
    chunk), with decays, a reset and a nonzero end-state cotangent: the
    split forward's o, state and log decay, and the split K2b's dk, dv
    and dlog_a, against ``lasp2_chunk_fwd_plain`` and
    ``lasp2_chunk_bwd_dkv_plain`` at the card's limits (o 3e-4, state
    1e-4, log decay 1e-5, gradients 1e-3, dlog_a with S·2^-24·max|want|
    of slack)."""
    s, dk, dv = 200, 1057, 32
    q, k, v, la, do, dst = (torch.from_numpy(x)
                            for x in _chunk_case(5, 2, s, dk, dv))
    assert len(_slices(dk)) == 9 and _slices(dk)[-1].stop == dk
    o, st, ld = split_fwd_emulation(q, k, v, la)
    o_p, st_p, ld_p = lc.lasp2_chunk_fwd_plain(q, k, v, la, block_size=200)
    _close(o, o_p, TOL, "o")
    _close(st, st_p, 1e-4, "state")
    _close(ld, ld_p, LD_TOL, "log decay")
    dk_g, dv_g, dla = split_dkv_emulation(q, k, v, la, o_p, do, dst)
    want = lc.lasp2_chunk_bwd_dkv_plain(q, k, v, la, o_p, do, dst,
                                        block_size=200)
    _close(dk_g, want[0], GRAD_TOL, "dk")
    _close(dv_g, want[1], GRAD_TOL, "dv")
    slack = s * 2.0 ** -24 * float(want[2].abs().max())
    torch.testing.assert_close(dla, want[2], rtol=GRAD_TOL,
                               atol=GRAD_TOL + slack)


# ---------------------------------------------------------------------------
# Routes and refusals.
# ---------------------------------------------------------------------------

BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,dk,dv,route", [
    (BF16, 64, 64, "sm90"), (BF16, 128, 128, "sm90"), (BF16, 128, 64, "sm90"),
    (BF16, 16, 16, "simt"), (BF16, 32, 32, "simt"), (BF16, 8, 16, "simt"),
    (BF16, 1057, 32, "simt"), (BF16, 16513, 128, "simt"),
    (BF16, 64, 50, "simt"), (FP32, 128, 128, "simt"), (FP32, 1057, 32,
                                                       "simt")])
def test_chunk_route_table(dtype, dk, dv, route):
    assert lc._route(dtype, dk, dv) == route


@pytest.mark.parametrize("dtype,dk,dv,route", [
    (BF16, 16, 64, "sm90"), (FP32, 128, 128, "sm90"), (BF16, 256, 4, "sm90"),
    (BF16, 8, 16, "simt"), (BF16, 33, 16, "simt"), (BF16, 1057, 32, "simt"),
    (BF16, 16513, 128, "simt"), (FP32, 16, 6, "simt")])
def test_decode_route_table(dtype, dk, dv, route):
    assert ldm._route(dtype, dk, dv) == route


@pytest.mark.parametrize("dtype,dh,route", [
    (BF16, 64, "sm90"), (BF16, 128, "sm90"), (BF16, 8, "simt"),
    (BF16, 16, "simt"), (BF16, 32, "simt"), (BF16, 100, "simt"),
    (FP32, 8, "simt"), (FP32, 32, "simt"), (FP32, 128, "simt")])
def test_flash_route_table(dtype, dh, route):
    assert fl._route(dtype, dh) == route


def _meta(*shape, dtype=FP32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("bh,s,dk,dv", [
    (64, 512, 128, 128), (8, 37, 16, 16), (32, 256, 1057, 32),
    (64, 512, 16513, 128), (3, 1, 1, 1), (2, 100, 33, 50),
    (1, 8, lc.MAX_WIDTH, 1)])
def test_chunk_kernels_take_every_width(dtype, bh, s, dk, dv):
    """The card launches K1, K2a and K2b at any dk and dv (decided on meta
    tensors, no memory): the refusal predicate finds nothing."""
    q, v = _meta(bh, s, dk, dtype=dtype), _meta(bh, s, dv, dtype=dtype)
    la, dst = _meta(bh, s), _meta(bh, dk, dv)
    assert lc.refusal("lasp2_chunk_fwd", (q, q, v), (la,)) is None
    assert lc.refusal("lasp2_chunk_bwd_dkv", (q, q, v, v, v),
                      (la, dst)) is None


@pytest.mark.parametrize("case,exc,message", [
    ("float16", TypeError, "must share one dtype"),
    ("mixed", TypeError, "must share one dtype"),
    ("bf16 log a", TypeError, "log_a (and dstate) must be float32"),
    ("strided", ValueError, "inputs must be contiguous"),
    ("empty", ValueError, "BH >= 1, S >= 1"),
    ("too wide", ValueError, f"dk, dv from 1 to {lc.MAX_WIDTH}")])
def test_chunk_kernels_refuse_with_a_message(case, exc, message):
    q, v, la = _meta(2, 64, 24), _meta(2, 64, 32), _meta(2, 64)
    ts, f32s = {
        "float16": ((q.half(), q.half(), v.half()), (la,)),
        "mixed": ((q, q.bfloat16(), v), (la,)),
        "bf16 log a": ((q, q, v), (la.bfloat16(),)),
        "strided": ((_meta(2, 24, 64).transpose(1, 2), q, v), (la,)),
        "empty": ((_meta(2, 0, 24), _meta(2, 0, 24), _meta(2, 0, 32)),
                  (_meta(2, 0),)),
        "too wide": ((_meta(2, 64, lc.MAX_WIDTH + 1),) * 2 + (v,), (la,)),
    }[case]
    got = lc.refusal("lasp2_chunk_fwd", ts, f32s)
    assert got is not None and got[0] is exc and message in got[1]
    assert got[1].startswith("lasp2_chunk_fwd: ")


@pytest.mark.parametrize("dk,dv,refused", [
    (16, 16, None), (8, 16, None), (33, 6, None), (1057, 32, None),
    (16513, 128, None), (ldm.SIMT_MAX_DK, 1, None),
    (ldm.SIMT_MAX_DK + 1, 1, "dk from 1 to")])
def test_decode_takes_any_dk_up_to_its_shared_memory(dk, dv, refused):
    q, v = _meta(4, dk, dtype=BF16), _meta(4, dv, dtype=BF16)
    got = ldm.refusal(q, q, v, _meta(4), _meta(4, dk, dv), _meta(4))
    assert (got is None) == (refused is None)
    if refused:
        assert got[0] is ValueError and refused in got[1]
    bad = ldm.refusal(q, q, v, _meta(4), _meta(4, dk, dv, dtype=BF16),
                      _meta(4))
    assert bad[0] is TypeError and "must be float32" in bad[1]


@pytest.mark.parametrize("dh,refused", [
    (8, None), (16, None), (32, None), (100, None), (128, None),
    (160, "dh from 1 to 128")])
def test_flash_takes_any_dh_up_to_128(dh, refused):
    q = _meta(1, 4, 72, dh, dtype=BF16)
    lse = _meta(1, 4, 72)
    for name, ts, f32s in (("flash_attention_fwd", (q, q, q), ()),
                           ("flash_attention_bwd_dq", (q, q, q, q),
                            (lse, lse))):
        got = fl.refusal(name, ts, f32s)
        assert (got is None) == (refused is None)
        if refused:
            assert got[0] is ValueError and refused in got[1]
    mixed = fl.refusal("flash_attention_fwd", (q, q.float(), q), ())
    assert mixed[0] is TypeError and "one dtype" in mixed[1]


def test_the_cpu_runs_the_plain_versions_at_the_new_widths():
    """On CPU tensors the wrappers take their plain versions at every new
    width and no launch counter moves."""
    q, k, v, la, do, dst = (torch.from_numpy(x)
                            for x in _chunk_case(6, 1, 64, 1057, 32))
    counters = (lc.lasp2_chunk_fwd, lc.lasp2_chunk_bwd_dq,
                lc.lasp2_chunk_bwd_dkv, ldm.lasp2_decode_step,
                fl.flash_attention_fwd)
    before = [(c.launches, dict(c.route_launches)) for c in counters]
    o, st, ld = lc.lasp2_chunk_fwd(q, k, v, la, block_size=64)
    lc.lasp2_chunk_bwd(q, k, v, la, o, do, dst, block_size=64)
    ldm.lasp2_decode_step(q[:, 0], k[:, 0], v[:, 0], la[:, 0], st, ld)
    x = torch.zeros(1, 2, 8, 8)
    fl.flash_attention_fwd(x, x, x)
    assert [(c.launches, dict(c.route_launches)) for c in counters] == before


# ---------------------------------------------------------------------------
# Table 2's llama3-tiny at its own width.
# ---------------------------------------------------------------------------

TINY_VOCAB = 2048


def _tiny(B, module, hybrid):
    """``benchmarks/table2_convergence.py``'s ``_base_cfg`` and
    ``_variant`` (basic: identity, no decay, faithful; based: taylor, no
    decay, autodiff), in fp32."""
    cfg = B.ModelConfig(name="llama3-tiny", family="dense", n_layers=4,
                        d_model=128, n_heads=4, n_kv_heads=4, d_ff=352,
                        vocab_size=TINY_VOCAB, pattern=(B.LayerSpec(),),
                        dtype="float32")
    cfg = cfg.linearize(hybrid_every=4 if hybrid else 0)
    lac = {"basic": B.LinearAttnConfig("identity", "none", "faithful"),
           "based": B.LinearAttnConfig("taylor", "none", "autodiff")}[module]
    return dataclasses.replace(cfg, linear_attn=lac)


@pytest.mark.parametrize("module,hybrid", [("based", False),
                                           ("basic", True)],
                         ids=["based", "basic-hybrid4"])
def test_table2_tiny_logits_and_grads_match_reference(module, hybrid):
    """Logits (3e-4) and every parameter gradient (1e-3 of its leaf's
    scale) of ``lm_loss`` at llama3-tiny's width (heads of 32: taylor's
    key width 1057 for based), on 2 packed rows of 64 tokens with
    document starts mid-row."""
    jcfg, tcfg = _tiny(JB, module, hybrid), _tiny(TB, module, hybrid)
    assert tcfg.head_dim == 32
    assert [s.mixer for s in tcfg.layer_specs()].count("softmax") \
        == (1 if hybrid else 0)
    jparams = JM.init_params(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, TINY_VOCAB, (2, 65))
    inputs, labels = toks[:, :-1].astype(np.int32), \
        toks[:, 1:].astype(np.int32)
    resets = np.zeros((2, 64), bool)
    resets[:, 0] = True
    resets[0, 21] = resets[1, 40] = True

    def jloss(p):
        logits, _ = JM.forward(p, jnp.asarray(inputs), jcfg, remat="none",
                               resets=jnp.asarray(resets))
        return JM.lm_loss(logits, jnp.asarray(labels)), logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tp = _port(jparams, tcfg)
    leaves = [p.requires_grad_(True) for _, p in leaves_with_paths(tp)]
    logits = TM.forward(tp, torch.as_tensor(inputs), tcfg,
                        resets=torch.as_tensor(resets))
    loss = TM.lm_loss(logits, torch.as_tensor(labels))
    _close(logits[..., :TINY_VOCAB], np.asarray(jlogits)[..., :TINY_VOCAB],
           TOL, "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    it = iter(torch.autograd.grad(loss, leaves))
    _close_trees(tree_map(lambda _: next(it), tp), jg, tcfg, GRAD_TOL,
                 "grad")
