"""The chunk kernels' routes and the precision of their ``sm90`` designs,
on the CPU.

* ``lasp2_chunk._route`` is a fixed table for K1, K2a and K2b: bf16 with dk
  and dv in {64, 128} go to the tensor-core kernels (``sm90``), fp32 and
  every other shape to the CUDA-core kernels (``simt``). CPU tensors run
  the plain versions and move no launch counter.
* K2b's ``sm90`` kernel feeds its fp32 intermediates (the decayed scores sc
  and dsc, the carried state gradient N and Q ⊙ e^{cb}) to bf16 products as
  two bf16 terms each, x_hi = bf16(x) and x_lo = bf16(x − x_hi), and takes
  r and dlog_a's suffix sum in fp32 from dk's fp32 accumulator. Here a
  transcription of that arithmetic, chunk by chunk, last chunk first,
  meets the card's unchanged limits against the fp32 plain version
  ``lasp2_chunk_bwd_dkv_plain`` at BH 2 × S 2048 × 128 with document
  resets: dk and dv within 4e-2 absolute + relative, dlog_a within
  1e-3 + S·2^-24·max|want| + 1e-3·|want|. With one bf16 term in place of
  two, dlog_a leaves that limit: the split is what meets it.
* K1 and K2a share one ``sm90`` kernel body, K1 with its operands
  swapped: it carries M ← e^A M + (A ⊙ w)ᵀ B with A ⊙ w (K2a: K ⊙ w; K1:
  V ⊙ w) in two terms, and takes M (in Q M and dO Mᵀ) and the decayed
  score tile (in S V and dsc K) in two terms as well. Its transcriptions
  meet the unchanged limits against ``lasp2_chunk_fwd_plain`` and
  ``lasp2_chunk_bwd_dq_plain`` (o 4e-2, state 1e-4, log decay 1e-5, dq
  4e-2) at BH 2 × S 2048 × 128; one term of A ⊙ w misses the state limit,
  one term of M misses o's and dq's, one term of dsc misses dq's, and one
  term of K1's scores stays inside o's limit with over twice the error of
  two.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.linear_attention import RESET_LOG_A, pick_block
from repro_torch.kernels import lasp2_chunk as lc

CHUNK = 64          # rows per chunk of the sm90 kernel


@pytest.mark.parametrize("dtype,dk,dv,route", [
    (torch.bfloat16, 64, 64, "sm90"), (torch.bfloat16, 64, 128, "sm90"),
    (torch.bfloat16, 128, 64, "sm90"), (torch.bfloat16, 128, 128, "sm90"),
    (torch.bfloat16, 16, 64, "simt"), (torch.bfloat16, 32, 192, "simt"),
    (torch.bfloat16, 128, 192, "simt"), (torch.float32, 128, 128, "simt"),
    (torch.float32, 64, 64, "simt")])
def test_route_table(dtype, dk, dv, route):
    assert lc._route(dtype, dk, dv) == route
    assert route in lc.ROUTES


def test_cpu_tensors_take_no_route():
    """On the CPU the wrapper runs its plain version: no launch counter,
    total or per route, moves."""
    q, k, v, la, o, do, dst = _inputs(0, 1, 128, 64, "reset")
    before = (lc.lasp2_chunk_bwd_dkv.launches,
              dict(lc.lasp2_chunk_bwd_dkv.route_launches))
    lc.lasp2_chunk_bwd_dkv(q, k, v, la, o, do, dst)
    assert (lc.lasp2_chunk_bwd_dkv.launches,
            dict(lc.lasp2_chunk_bwd_dkv.route_launches)) == before


def _inputs(seed, bh, s, d, la_kind):
    """bf16 q, k, v, dO and o (from the plain forward), fp32 log a and dM,
    as the card's train path hands them to K2b."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    q, k = randn(bh, s, d, scale=0.3), randn(bh, s, d, scale=0.3)
    v = randn(bh, s, d, scale=0.5)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    la = torch.zeros(bh, s)
    if la_kind == "reset":        # document starts, as packed training rows
        for at in (5, s // 4 + 3, s // 2 - 7, (3 * s) // 4 + 11):
            la[:, min(at, s - 1)] = RESET_LOG_A
    elif la_kind == "decay":
        la = -randn(bh, s).abs() * 0.03
    o, _, _ = lc.lasp2_chunk_fwd_plain(q, k, v, la,
                                       block_size=pick_block(s, 128))
    do = randn(bh, s, d).bfloat16()
    dst = randn(bh, d, d)
    return q, k, v, la, o, do, dst


def _terms(x, n):
    """x (fp32) as the n bf16 terms the kernel's products take."""
    hi = x.bfloat16().float()
    return [hi] if n == 1 else [hi, (x - hi).bfloat16().float()]


def _mm(a_terms, b):
    """Σ over the terms of a · b, each product in fp32 (the tensor cores'
    accumulator): the terms' values are bf16, b's too."""
    return sum(a @ b for a in a_terms)


def sm90_dkv_emulation(q, k, v, la, o, do, dst, *, n_terms=2):
    """The ``sm90`` kernel's arithmetic on the CPU: 64-row chunks, last
    first; S1ᵀ = K Qᵀ and S2ᵀ = V dOᵀ from bf16 inputs in fp32; dk = w ⊙
    (V N_termsᵀ) + dsc_termsᵀ Q, dv = w ⊙ (K N_terms) + sc_termsᵀ dO; r from
    the fp32 dk; N ← e^A N + (Q ⊙ e^{cb})_termsᵀ dO. Returns (dk, dv in
    bf16, dla fp32)."""
    bh, s, dk_w = q.shape
    n = dst.float()
    rsum = torch.zeros(bh, 1)
    dks, dvs, dlas = [], [], []
    nch = -(-s // CHUNK)
    for ch in reversed(range(nch)):
        rows = slice(ch * CHUNK, min(s, (ch + 1) * CHUNK))
        qb, kb, vb, ob, dob = (x[:, rows].float() for x in (q, k, v, o, do))
        cb = torch.cumsum(la[:, rows], dim=-1)
        a_blk = cb[:, -1:]
        dmat = lc._decay_mat(cb)                          # (bh, C, C), i >= j
        w = torch.exp(a_blk - cb)[..., None]
        n_t = _terms(n, n_terms)
        # the transposed scores dscᵀ[j][i] and scᵀ[j][i], masked i >= j
        dsc_t = (vb @ dob.transpose(1, 2)) * dmat.transpose(1, 2)
        sc_t = (kb @ qb.transpose(1, 2)) * dmat.transpose(1, 2)
        dkb = w * sum(vb @ t.transpose(1, 2) for t in n_t) \
            + _mm(_terms(dsc_t, n_terms), qb)
        dvb = w * sum(kb @ t for t in n_t) + _mm(_terms(sc_t, n_terms), dob)
        r = (dob * ob).sum(-1) - (kb * dkb).sum(-1)
        suffix = r.sum(-1, keepdim=True) - torch.cumsum(r, dim=-1) + r
        dlas.append(suffix + rsum)
        rsum = rsum + r.sum(-1, keepdim=True)
        qe = qb * torch.exp(cb)[..., None]
        n = torch.exp(a_blk)[..., None] * n \
            + _mm([t.transpose(1, 2) for t in _terms(qe, n_terms)], dob)
        dks.append(dkb)
        dvs.append(dvb)
    return (torch.cat(dks[::-1], 1).bfloat16(),
            torch.cat(dvs[::-1], 1).bfloat16(), torch.cat(dlas[::-1], 1))


def _within_limits(got, want, s):
    """The card's K2b limits against the fp32 plain version: dk, dv within
    4e-2 absolute + relative; dlog_a within 1e-3 + S·2^-24·max|want| +
    1e-3·|want|. Returns (ok per output, worst |err| per output)."""
    oks, errs = [], []
    for g, w in zip(got[:2], want[:2]):
        diff = (g.float() - w.float()).abs()
        oks.append(bool((diff <= 4e-2 + 4e-2 * w.float().abs()).all()))
        errs.append(float(diff.max()))
    slack = s * 2.0 ** -24 * float(want[2].abs().max())
    diff = (got[2] - want[2]).abs()
    oks.append(bool((diff <= 1e-3 + slack + 1e-3 * want[2].abs()).all()))
    errs.append(float(diff.max()))
    return oks, errs


@pytest.mark.parametrize("la_kind", ["reset", "decay"])
def test_split_bf16_products_meet_fp32_limits(la_kind):
    """The kernel's two-term products at BH 2 × S 2048 × 128 meet the
    unchanged dk, dv and dlog_a limits against the fp32 plain version."""
    s = 2048
    ins = _inputs(1, 2, s, 128, la_kind)
    want = lc.lasp2_chunk_bwd_dkv_plain(*ins, block_size=pick_block(s, 128))
    got = sm90_dkv_emulation(*ins)
    oks, errs = _within_limits(got, want, s)
    assert all(oks), f"dk, dv, dla within limits {oks}, max errors {errs}"


def test_one_bf16_term_misses_the_dla_limit():
    """The same arithmetic with one bf16 rounding of each fp32 operand (no
    lo term) leaves dlog_a's limit at the same inputs: the split is
    needed."""
    s = 2048
    ins = _inputs(1, 2, s, 128, "reset")
    want = lc.lasp2_chunk_bwd_dkv_plain(*ins, block_size=pick_block(s, 128))
    oks, errs = _within_limits(sm90_dkv_emulation(*ins, n_terms=1), want, s)
    assert not oks[2], f"one term met the dla limit: max error {errs[2]}"


@pytest.mark.parametrize("s", [37, 200])
def test_emulation_handles_a_ragged_last_chunk(s):
    """A ragged last chunk (S not a multiple of 64) is exact: the kernel's
    zero-filled tail adds nothing."""
    ins = _inputs(2, 2, s, 64, "reset")
    want = lc.lasp2_chunk_bwd_dkv_plain(*ins, block_size=pick_block(s, 128))
    oks, errs = _within_limits(sm90_dkv_emulation(*ins), want, s)
    assert all(oks), f"{oks}, {errs}"


# ---------------------------------------------------------------------------
# K1 and K2a: the forward and the dq pass.
# ---------------------------------------------------------------------------

def test_cpu_tensors_move_no_fwd_or_dq_counter():
    """On the CPU, K1's and K2a's wrappers run their plain versions: no
    launch counter, total or per route, moves."""
    q, k, v, la, _, do, _ = _inputs(0, 1, 128, 64, "reset")
    fns = (lc.lasp2_chunk_fwd, lc.lasp2_chunk_bwd_dq)
    before = [(fn.launches, dict(fn.route_launches)) for fn in fns]
    lc.lasp2_chunk_fwd(q, k, v, la)
    lc.lasp2_chunk_bwd_dq(k, v, la, do)
    assert [(fn.launches, dict(fn.route_launches)) for fn in fns] == before
    assert all(set(fn.route_launches) == set(lc.ROUTES) for fn in fns)


def sm90_chunk_emulation(a, b, la, x, *, n_score=2, n_state=2, n_kw=2):
    """The arithmetic of the one ``sm90`` kernel body of K1 and K2a on the
    CPU: 64-row chunks in order; sc = X Bᵀ from bf16 inputs in fp32, sc ⊙ D;
    out = sc_terms A + e^{cb} ⊙ (X M_termsᵀ) with M the state before the
    chunk; then M ← e^{cb_last} M + (A ⊙ w)_termsᵀ B. Returns (out in bf16,
    the final M, sum(log a))."""
    bh, s, na = a.shape
    m = torch.zeros(bh, na, b.shape[-1])
    ld = torch.zeros(bh)
    outs = []
    for ch in range(-(-s // CHUNK)):
        rows = slice(ch * CHUNK, min(s, (ch + 1) * CHUNK))
        ab, bb, xb = (t[:, rows].float() for t in (a, b, x))
        cb = torch.cumsum(la[:, rows], dim=-1)
        sc = (xb @ bb.transpose(1, 2)) * lc._decay_mat(cb)
        outs.append(_mm(_terms(sc, n_score), ab) + torch.exp(cb)[..., None]
                    * sum(xb @ t.transpose(1, 2) for t in _terms(m, n_state)))
        a_last = cb[:, -1:]
        aw = ab * torch.exp(a_last - cb)[..., None]
        m = torch.exp(a_last)[..., None] * m \
            + _mm([t.transpose(1, 2) for t in _terms(aw, n_kw)], bb)
        ld = ld + cb[:, -1]
    return torch.cat(outs, 1).to(a.dtype), m, ld


def sm90_fwd_emulation(q, k, v, la, **terms):
    """K1: the kernel body with (A, B, X) = (v, k, q), whose carried M is
    the transpose of the forward's state. Returns (o, state, log decay)."""
    o, m, ld = sm90_chunk_emulation(v, k, la, q, **terms)
    return o, m.transpose(1, 2), ld


def sm90_dq_emulation(k, v, la, do, **terms):
    """K2a: the kernel body with (A, B, X) = (k, v, dO). Returns dq."""
    return sm90_chunk_emulation(k, v, la, do, **terms)[0]


def _worst(got, want, tol):
    """The largest |got − want| / (tol + tol·|want|): at most 1 within the
    card's limit."""
    return float(((got.float() - want.float()).abs()
                  / (tol + tol * want.float().abs())).max())


def _fwd_bwd_ratios(seed, s, d, la_kind, **terms):
    """(o, state, log decay, dq) worst errors against the plain versions as
    fractions of the card's limits (``TOL_O``, ``TOL_STATE``, ``TOL_LD``,
    ``TOL_GRAD``), for the emulations with ``terms``."""
    q, k, v, la, _, do, _ = _inputs(seed, 2, s, d, la_kind)
    bs = pick_block(s, 128)
    o_p, st_p, ld_p = lc.lasp2_chunk_fwd_plain(q, k, v, la, block_size=bs)
    dq_p = lc.lasp2_chunk_bwd_dq_plain(k, v, la, do, block_size=bs)
    o, st, ld = sm90_fwd_emulation(q, k, v, la, **terms)
    dq = sm90_dq_emulation(k, v, la, do, **terms)
    return (_worst(o, o_p, 4e-2), _worst(st, st_p, 1e-4),
            _worst(ld, ld_p, 1e-5), _worst(dq, dq_p, 4e-2))


@pytest.mark.parametrize("la_kind", ["zero", "reset", "decay"])
def test_fwd_and_dq_two_term_products_meet_fp32_limits(la_kind):
    """K1's and K2a's two-term products at BH 2 × S 2048 × 128 meet the
    unchanged o, state, log decay and dq limits against the fp32 plain
    versions, with no decay (the largest state), resets and decays."""
    ratios = _fwd_bwd_ratios(1, 2048, 128, la_kind)
    assert max(ratios) <= 1.0, f"o, state, ld, dq at {ratios} of the limits"


@pytest.mark.parametrize("operand,la_kind,misses", [
    ("n_kw", "decay", "state"),      # V ⊙ w: 2^-9 of a row, decayed sums
    ("n_state", "reset", "o"),       # M in Q M
    ("n_state", "reset", "dq"),      # M in dO Mᵀ
    ("n_score", "reset", "dq")])     # dsc in dsc K
def test_one_bf16_term_misses_a_limit(operand, la_kind, misses):
    """With one bf16 term of ``operand`` (the others in two), the output
    ``misses`` leaves its limit at BH 2 × S 2048 × 128: that operand needs
    two terms."""
    ratios = dict(zip(("o", "state", "ld", "dq"),
                      _fwd_bwd_ratios(1, 2048, 128, la_kind, **{operand: 1})))
    assert ratios[misses] > 1.0, f"one term of {operand}: {ratios}"


def test_one_term_scores_fit_o_with_less_margin():
    """K1's score tile in one bf16 term keeps o inside its limit at BH 2 ×
    S 2048, but its worst error is over 0.4 of the limit and over twice
    that of two terms: the kernel takes two, for margin at the card's
    larger shapes."""
    one = _fwd_bwd_ratios(1, 2048, 128, "reset", n_score=1)[0]
    two = _fwd_bwd_ratios(1, 2048, 128, "reset")[0]
    assert 0.4 < one <= 1.0 and one > 2 * two, (one, two)


@pytest.mark.parametrize("s", [37, 200])
def test_fwd_and_dq_emulations_handle_a_ragged_last_chunk(s):
    """A ragged last chunk (S not a multiple of 64) is exact in K1's and
    K2a's arithmetic: the kernels' zero-filled tail adds nothing."""
    ratios = _fwd_bwd_ratios(2, s, 64, "reset")
    assert max(ratios) <= 1.0, ratios
