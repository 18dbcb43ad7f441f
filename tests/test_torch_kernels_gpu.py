"""The port's CUDA kernels against their plain PyTorch versions over a
sweep of shapes. Needs a CUDA card: marked ``gpu`` and skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: o at the reference's kernel tolerances (3e-4 fp32, 4e-2 bf16,
``tests/test_kernels.py:14``); states in fp32 at 1e-4 (both sides sum in
fp32, in chunks of 64 against blocks of up to 128); log decay at 1e-5;
flash lse (fp32 on both sides) at 1e-4; gradients at the reference's 1e-3
(4e-2 for bf16 outputs). K1, K2a and K2b run on both routes (``sm90``
for bf16 with dk and dv in {64, 128}, ``simt`` otherwise), each held to
the same limits against the fp32 plain version. K3, the decode step, runs
on each route by ``route=`` (its table sends dk a multiple of 16 up to 256
with dv a multiple of 4 to ``sm90``, the rest to ``simt``), at the same
limits, in place, and on ``sm90`` also bitwise repeatable and inside a
replayed CUDA graph. Besides the widths the models had before, every
kernel runs at the shapes the reference's Pallas kernels take and the
repo's configs hand them: chunk (dk, dv) = (16, 16), (32, 32), (8, 16)
(hymba SMOKE's SSD heads), odd (33, 50), (130, 70) just past one dk slice
and the taylor widths (1057, 32) and (16513, 128), all on ``simt`` (K1
and K2b split dk past 128 rows into slices they reduce in a second
kernel, bitwise repeatable); K3 at dk 8, 33, 1057 and 16513 on ``simt``;
flash at dh 8, 32 and 100 (run at the next built width, 16, 32 or 128).
bf16 flash results at 2^-7·|want| + 2^-8·rms(want), plus, on the ``sm90``
route of K4, K5a and K5b, which rounds P and dS to bf16 inside its
products, 2^-8 times those products over absolute values
(``fl.sm90_rounding_bound``).
"""

import math

import pytest
import torch

from repro_torch.core.linear_attention import RESET_LOG_A, pick_block
from repro_torch.kernels import lasp2_chunk as lc
from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_bwd,
                                             lasp2_chunk_bwd_dkv,
                                             lasp2_chunk_bwd_dq,
                                             lasp2_chunk_bwd_plain,
                                             lasp2_chunk_fwd,
                                             lasp2_chunk_fwd_plain)
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import lasp2_decode as lasp2_decode_mod
from repro_torch.kernels.lasp2_decode import (lasp2_decode_step,
                                              lasp2_decode_step_plain)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 3e-4, torch.bfloat16: 4e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _close_bf16(got, want, extra=None):
    """bf16 results both sides accumulate in fp32 and round once: within
    one bf16 step (2^-7·|want|) plus 2^-8 of the tensor's rms for entries
    near zero, a limit that scales with the data; plus ``extra`` (the
    ``sm90`` route's rounding of P and dS) where given."""
    got, want = got.float(), want.float()
    rms = float(want.pow(2).mean().sqrt())
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -8 * rms
    if extra is not None:
        limit = limit + extra
    bad = (got - want).abs() > limit
    assert not bool(bad.any()), \
        f"{int(bad.sum())} entries off, max {float((got - want).abs().max())}"


# the shapes the models had before, then every width the Pallas kernels
# take: SMOKE's and Table 2's heads, hymba SMOKE's SSD heads, odd widths,
# one row past a dk slice, and the taylor feature map at Table 2's dh 32
NEW_CHUNK_SHAPES = [(16, 16), (32, 32), (8, 16), (33, 50), (130, 70),
                    (1057, 32)]


@pytest.mark.parametrize("s", [1, 37, 64, 200, 512])
@pytest.mark.parametrize("dk,dv", [(16, 64), (64, 64), (128, 128),
                                   (64, 128), (128, 64), (32, 192)]
                         + NEW_CHUNK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_kernel_matches_plain(gen, s, dk, dv, dtype):
    bh = 6
    q = (torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3)
    k = (torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3)
    v = (torch.randn(bh, s, dv, generator=gen, device="cuda") * 0.5)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    la = -torch.rand(bh, s, generator=gen, device="cuda") * 0.05
    la[:, s // 3] = RESET_LOG_A
    route = lc._route(dtype, dk, dv)
    before = dict(lasp2_chunk_fwd.route_launches)
    o, st, ld = lasp2_chunk_fwd(q, k, v, la)
    torch.cuda.synchronize()
    assert {r: lasp2_chunk_fwd.route_launches[r] - before[r] for r in before} \
        == {r: int(r == route) for r in before}
    o_p, st_p, ld_p = lasp2_chunk_fwd_plain(q, k, v, la,
                                            block_size=pick_block(s, 128))
    assert o.dtype == dtype and st.dtype == torch.float32
    _close(o, o_p, TOL[dtype])
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)


DECODE_SHAPES = [(16, 16), (64, 128), (128, 64), (128, 128), (32, 200),
                 (16, 64), (16, 260)]


def _decode_inputs(gen, bh, dk, dv, dtype):
    q, k = (torch.randn(bh, dk, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    v = torch.randn(bh, dv, generator=gen, device="cuda").to(dtype)
    la = -torch.rand(bh, generator=gen, device="cuda") * 0.1
    return q, k, v, la


@pytest.mark.parametrize("bh", [1, 10, 64])
@pytest.mark.parametrize("route", lasp2_decode_mod.ROUTES)
@pytest.mark.parametrize("dk,dv", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_in_place(gen, dk, dv, dtype, route, bh):
    st0 = torch.randn(bh, dk, dv, generator=gen, device="cuda")
    ld0 = -torch.rand(bh, generator=gen, device="cuda")
    st, ld = st0.clone(), ld0.clone()
    st_p, ld_p = st0.clone(), ld0.clone()
    before = dict(lasp2_decode_step.route_launches)
    for _ in range(4):
        q, k, v, la = _decode_inputs(gen, bh, dk, dv, dtype)
        o, st_out, ld_out = lasp2_decode_step(q, k, v, la, st, ld,
                                              route=route)
        assert st_out.data_ptr() == st.data_ptr()      # updated in place
        o_p, st_p, ld_p = lasp2_decode_step_plain(q, k, v, la, st_p, ld_p)
        _close(o, o_p, TOL[torch.float32])
    torch.cuda.synchronize()
    assert {r: lasp2_decode_step.route_launches[r] - before[r]
            for r in before} == {r: 4 * (r == route) for r in before}
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)


@pytest.mark.parametrize("dk,dv", [(128, 128), (32, 200), (16, 64)])
def test_decode_sm90_is_bitwise_repeatable(gen, dk, dv):
    """Fixed-order sums, no atomics: two launches on the same inputs agree
    bit for bit."""
    q, k, v, la = _decode_inputs(gen, 64, dk, dv, torch.bfloat16)
    st0 = torch.randn(64, dk, dv, generator=gen, device="cuda")
    ld0 = -torch.rand(64, generator=gen, device="cuda")
    outs = []
    for _ in range(2):
        st, ld = st0.clone(), ld0.clone()
        o, _, _ = lasp2_decode_step(q, k, v, la, st, ld, route="sm90")
        outs.append((o, st, ld))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.parametrize("route", lasp2_decode_mod.ROUTES)
def test_decode_takes_a_null_log_a(gen, route):
    """log_a None is log a = 0: the state is not decayed and log decay is
    left as it was."""
    q, k, v, _ = _decode_inputs(gen, 10, 128, 64, torch.bfloat16)
    st = torch.randn(10, 128, 64, generator=gen, device="cuda")
    ld = -torch.rand(10, generator=gen, device="cuda")
    st_p, ld_p = st.clone(), ld.clone()
    o, _, ld_out = lasp2_decode_step(q, k, v, None, st, ld, route=route)
    o_p, st_p, _ = lasp2_decode_step_plain(q, k, v, None, st_p, ld_p)
    torch.cuda.synchronize()
    _close(o, o_p, TOL[torch.float32])
    _close(st, st_p, 1e-4)
    assert torch.equal(ld_out, ld_p)


def test_decode_sm90_replays_in_a_cuda_graph(gen):
    """One sm90 launch captured in a CUDA graph, replayed 8 times on fresh
    inputs copied into its static tensors, matches 8 plain steps: the state
    is updated in place on every replay."""
    bh, dk, dv = 64, 128, 128
    st = torch.randn(bh, dk, dv, generator=gen, device="cuda")
    ld = -torch.rand(bh, generator=gen, device="cuda")
    st_p, ld_p = st.clone(), ld.clone()
    static = _decode_inputs(gen, bh, dk, dv, torch.bfloat16)
    warm_st, warm_ld = st.clone(), ld.clone()     # builds and loads first
    lasp2_decode_step(*static, warm_st, warm_ld)
    torch.cuda.synchronize()
    before = lasp2_decode_step.route_launches["sm90"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, _, _ = lasp2_decode_step(*static, st, ld)
    assert lasp2_decode_step.route_launches["sm90"] == before + 1
    for _ in range(8):
        fresh = _decode_inputs(gen, bh, dk, dv, torch.bfloat16)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        o_p, st_p, ld_p = lasp2_decode_step_plain(*fresh, st_p, ld_p)
        torch.cuda.synchronize()
        _close(o, o_p, TOL[torch.float32])
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)


@pytest.mark.parametrize("dk,dv", [(128, 30), (272, 64), (64, 2),
                                   (64, 258), (8, 16), (33, 16), (1057, 32),
                                   (16513, 128)])
def test_decode_routes_shapes_sm90_does_not_take_to_simt(gen, dk, dv):
    """Shapes outside the sm90 table launch the simt kernel, not an error;
    forcing sm90 on them raises."""
    q, k, v, la = _decode_inputs(gen, 4, dk, dv, torch.bfloat16)
    st = torch.randn(4, dk, dv, generator=gen, device="cuda")
    ld = torch.zeros(4, device="cuda")
    st_p, ld_p = st.clone(), ld.clone()
    before = dict(lasp2_decode_step.route_launches)
    o, _, _ = lasp2_decode_step(q, k, v, la, st, ld)
    o_p, st_p, ld_p = lasp2_decode_step_plain(q, k, v, la, st_p, ld_p)
    torch.cuda.synchronize()
    assert {r: lasp2_decode_step.route_launches[r] - before[r]
            for r in before} == {"sm90": 0, "simt": 1}
    _close(o, o_p, TOL[torch.float32])
    _close(st, st_p, 1e-4)
    with pytest.raises(ValueError, match="route 'sm90' does not take"):
        lasp2_decode_step(q, k, v, la, st, ld, route="sm90")


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    """Every width is taken now; an empty sequence, a dtype outside bf16
    and fp32, mixed devices, non-contiguous inputs and a non-fp32 log a
    are not."""
    q = torch.zeros(2, 0, 24, device="cuda")           # S = 0
    la = torch.zeros(2, 0, device="cuda")
    with pytest.raises(ValueError, match="S >= 1"):
        lasp2_chunk_fwd(q, q, q, la)
    h = torch.zeros(2, 8, 24, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="one dtype"):
        lasp2_chunk_fwd(h, h, h, torch.zeros(2, 8, device="cuda"))
    with pytest.raises(ValueError, match="several devices"):
        lasp2_chunk_fwd(h.float(), h.float(), h.float(), torch.zeros(2, 8))
    q = torch.zeros(2, 8, 24, device="cuda")
    la = torch.zeros(2, 8, device="cuda")
    x = torch.zeros(2, 16, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        lasp2_chunk_fwd(x.transpose(1, 2), x.transpose(1, 2),
                        torch.zeros(2, 8, 64, device="cuda"), la)
    with pytest.raises(TypeError, match="float32"):
        lasp2_chunk_fwd(q[..., :16], q[..., :16],
                        torch.zeros(2, 8, 64, device="cuda"), la.half())


def _bwd_inputs(gen, bh, s, dk, dv, dtype):
    q = torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3
    k = torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3
    v = torch.randn(bh, s, dv, generator=gen, device="cuda") * 0.5
    q, k, v = (x.to(dtype) for x in (q, k, v))
    la = -torch.rand(bh, s, generator=gen, device="cuda") * 0.05
    la[:, s // 3] = RESET_LOG_A
    la[:, (2 * s) // 3] = RESET_LOG_A
    o, _, _ = lasp2_chunk_fwd_plain(q, k, v, la, block_size=pick_block(s, 128))
    do = torch.randn(bh, s, dv, generator=gen, device="cuda").to(dtype)
    dst = torch.randn(bh, dk, dv, generator=gen, device="cuda")
    return q, k, v, la, o, do, dst


@pytest.mark.parametrize("s", [1, 37, 64, 200, 512])
@pytest.mark.parametrize("dk,dv", [(dk, dv) for dk in (16, 32, 64, 128)
                                   for dv in (64, 128, 192)]
                         + NEW_CHUNK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_bwd_kernels_match_plain(gen, s, dk, dv, dtype):
    """K2a and K2b against the plain passes, with resets and decays, each on
    the route its inputs take (bf16 with dk, dv in {64, 128}: ``sm90``).
    Gradients within 1e-3 in fp32 (the reference's GRAD_TOL) and 4e-2 in
    bf16. dlog_a is fp32 on both sides, from the same inputs: each entry
    is a suffix sum of up to S terms of the size of the largest entries,
    so besides 1e-3 it gets the fp32 rounding of such a sum taken in
    another order, S·2^-24·max|dlog_a|, as absolute slack."""
    bh = 3
    ins = _bwd_inputs(gen, bh, s, dk, dv, dtype)
    route = lc._route(dtype, dk, dv)
    before = [fn.route_launches[route]
              for fn in (lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)]
    got = lasp2_chunk_bwd(*ins)
    torch.cuda.synchronize()
    assert [fn.route_launches[route] - n for fn, n in zip(
        (lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv), before)] == [1, 1]
    want = lasp2_chunk_bwd_plain(*ins, block_size=pick_block(s, 128))
    tol = 1e-3 if dtype == torch.float32 else 4e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype, name
        _close(g, w, tol)
    assert got[3].dtype == torch.float32
    slack = s * 2.0 ** -24 * float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=1e-3,
                               atol=1e-3 + slack)


def _ssd_log_a(gen, bh, s, nh):
    """SSD's log a at init (``mamba2_init``): −h·softplus(dt_bias + noise)
    for head h = 1..nh of each row, dt_bias the softplus⁻¹ of a step
    drawn log-uniform in [1e-3, 0.1]; down to about −8 a token at nh 80."""
    head = (torch.arange(bh, device="cuda") % nh + 1).float()[:, None]
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand(bh, 1, generator=gen,
                                                device="cuda"))
    return -head * torch.nn.functional.softplus(
        torch.log(torch.expm1(dt0))
        + 0.1 * torch.randn(bh, s, generator=gen, device="cuda"))


@pytest.mark.parametrize("s", [37, 512])
@pytest.mark.parametrize("dk,dv,nh", [(128, 64, 80), (16, 64, 25)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_kernels_on_the_ssd_log_a(gen, s, dk, dv, nh, dtype):
    """K1, K2a and K2b at mamba2's (128, 64) and hymba's (16, 64) heads on
    SSD's log a (a reset mid-chunk), each on its route (bf16 at (128,
    64): ``sm90``), under the limits of ``test_chunk_kernel_matches_plain``
    and ``test_chunk_bwd_kernels_match_plain``."""
    bh = 2 * nh
    q = (torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3)
    k = (torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3)
    v = (torch.randn(bh, s, dv, generator=gen, device="cuda") * 0.5)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    la = _ssd_log_a(gen, bh, s, nh)
    la[:, s // 2] = RESET_LOG_A
    o, st, ld = lasp2_chunk_fwd(q, k, v, la)
    torch.cuda.synchronize()
    o_p, st_p, ld_p = lasp2_chunk_fwd_plain(q, k, v, la,
                                            block_size=pick_block(s, 128))
    _close(o, o_p, TOL[dtype])
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)
    do = torch.randn(bh, s, dv, generator=gen, device="cuda").to(dtype)
    dst = torch.randn(bh, dk, dv, generator=gen, device="cuda")
    got = lasp2_chunk_bwd(q, k, v, la, o_p.to(dtype), do, dst)
    want = lasp2_chunk_bwd_plain(q, k, v, la, o_p.to(dtype), do, dst,
                                 block_size=pick_block(s, 128))
    tol = 1e-3 if dtype == torch.float32 else 4e-2
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, tol)
    slack = s * 2.0 ** -24 * float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=1e-3,
                               atol=1e-3 + slack)


@pytest.mark.parametrize("route", lasp2_decode_mod.ROUTES)
@pytest.mark.parametrize("dk,dv,nh", [(128, 64, 80), (16, 64, 25)])
def test_decode_kernel_on_the_ssd_log_a(gen, dk, dv, nh, route):
    """K3 at the SSD heads' shapes, 8 chained steps on SSD's log a (a reset
    at step 3 for half the rows), bf16 q/k/v, in place, against the plain
    step."""
    bh = 2 * nh
    st0 = torch.randn(bh, dk, dv, generator=gen, device="cuda")
    ld0 = -torch.rand(bh, generator=gen, device="cuda")
    st, ld = st0.clone(), ld0.clone()
    st_p, ld_p = st0.clone(), ld0.clone()
    for i in range(8):
        q, k, v, _ = _decode_inputs(gen, bh, dk, dv, torch.bfloat16)
        la = _ssd_log_a(gen, bh, 1, nh)[:, 0].contiguous()
        if i == 3:
            la[: bh // 2] = RESET_LOG_A
        o, _, _ = lasp2_decode_step(q, k, v, la, st, ld, route=route)
        o_p, st_p, ld_p = lasp2_decode_step_plain(q, k, v, la, st_p, ld_p)
        _close(o, o_p, TOL[torch.float32])
    torch.cuda.synchronize()
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)


def test_chunk_autograd_launches_both_passes(gen):
    """Autograd through ops.linear_attention_op on the card launches K1
    once and K2a, K2b once each, and pulling only on the state gives
    dq == 0 exactly."""
    from repro_torch.kernels import ops
    q, k, v, la, _, _, dst = _bwd_inputs(gen, 4, 256, 64, 64, torch.float32)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v, la)]
    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    before = [c.launches for c in counters]
    _, st, _ = ops.linear_attention_op(xs[0][None], xs[1][None],
                                       xs[2][None], xs[3][None])
    grads = torch.autograd.grad((st[0] * dst).sum(), xs)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
    assert float(grads[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,route", [(torch.float32, "simt"),
                                         (torch.bfloat16, "sm90")])
def test_chunk_autograd_takes_the_k2b_route(gen, dtype, route):
    """Autograd through ops.linear_attention_op on the card launches K1,
    K2a and K2b once each, on ``sm90`` for bf16 at dk = dv = 64 and on
    ``simt`` for fp32, never on the other route."""
    from repro_torch.kernels import ops
    ins = _bwd_inputs(gen, 4, 200, 64, 64, dtype)
    xs = [x.clone().requires_grad_(True) for x in ins[:4]]
    counters = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    before = [dict(c.route_launches) for c in counters]
    o, _, _ = ops.linear_attention_op(*(x[None] for x in xs))
    grads = torch.autograd.grad((o.float() * ins[5][None].float()).sum(), xs)
    for c, b in zip(counters, before):
        moved = {r: c.route_launches[r] - b[r] for r in b}
        assert moved == {r: int(r == route) for r in b}, c.__name__
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128)])
def test_chunk_dkv_sm90_is_bitwise_repeatable(gen, dk, dv):
    """K2b on the ``sm90`` route sums in a fixed order with no atomics: two
    launches on the same inputs agree bit for bit."""
    ins = _bwd_inputs(gen, 4, 1000, dk, dv, torch.bfloat16)
    first = lasp2_chunk_bwd_dkv(*ins)
    second = lasp2_chunk_bwd_dkv(*ins)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (64, 128)])
def test_chunk_fwd_sm90_is_bitwise_repeatable(gen, dk, dv):
    """K1 on the ``sm90`` route sums in a fixed order with no atomics: two
    launches on the same inputs agree bit for bit, o, state and log decay."""
    q, k, v, la, *_ = _bwd_inputs(gen, 4, 1000, dk, dv, torch.bfloat16)
    before = lasp2_chunk_fwd.route_launches["sm90"]
    first = lasp2_chunk_fwd(q, k, v, la)
    second = lasp2_chunk_fwd(q, k, v, la)
    torch.cuda.synchronize()
    assert lasp2_chunk_fwd.route_launches["sm90"] - before == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (128, 64)])
def test_chunk_dq_sm90_is_bitwise_repeatable(gen, dk, dv):
    """K2a on the ``sm90`` route sums in a fixed order with no atomics: two
    launches on the same inputs agree bit for bit."""
    _, k, v, la, _, do, _ = _bwd_inputs(gen, 4, 1000, dk, dv, torch.bfloat16)
    before = lasp2_chunk_bwd_dq.route_launches["sm90"]
    first = lasp2_chunk_bwd_dq(k, v, la, do)
    second = lasp2_chunk_bwd_dq(k, v, la, do)
    torch.cuda.synchronize()
    assert lasp2_chunk_bwd_dq.route_launches["sm90"] - before == 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("dk,dv", [(1057, 32), (16513, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_kernels_at_the_taylor_widths(gen, dk, dv, dtype):
    """K1, K2a and K2b at the taylor feature map's key widths, 1 + dh + dh²
    at Table 2's dh 32 and Linear-Llama3-1B's 128, BH 4 x S 256 (dk split
    into 9 and 130 slices), on ``simt``, against the plain versions at the
    limits of ``test_chunk_bwd_kernels_match_plain``."""
    ins = _bwd_inputs(gen, 4, 256, dk, dv, dtype)
    q, k, v, la = ins[:4]
    passes = (lasp2_chunk_fwd, lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)
    before = [fn.route_launches["simt"] for fn in passes]
    o, st, ld = lasp2_chunk_fwd(q, k, v, la)
    got = lasp2_chunk_bwd(*ins)
    torch.cuda.synchronize()
    assert [fn.route_launches["simt"] - n
            for fn, n in zip(passes, before)] == [1, 1, 1]
    o_p, st_p, ld_p = lasp2_chunk_fwd_plain(q, k, v, la, block_size=128)
    _close(o, o_p, TOL[dtype])
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)
    want = lasp2_chunk_bwd_plain(*ins, block_size=128)
    tol = 1e-3 if dtype == torch.float32 else 4e-2
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, tol)
    slack = 256 * 2.0 ** -24 * float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=1e-3,
                               atol=1e-3 + slack)


@pytest.mark.parametrize("dk,dv", [(16, 16), (130, 70), (1057, 32),
                                   (16513, 128)])
def test_chunk_simt_is_bitwise_repeatable(gen, dk, dv):
    """K1, K2a and K2b on ``simt`` sum in a fixed order with no atomics,
    across dk slices too (the slices' partial o, dv and rowsum(K ⊙ dk)
    reduced in slice order): two launches agree bit for bit."""
    ins = _bwd_inputs(gen, 4, 200, dk, dv, torch.float32)
    q, k, v, la, _, do, _ = ins
    for fn, args in ((lasp2_chunk_fwd, (q, k, v, la)),
                     (lasp2_chunk_bwd_dq, (k, v, la, do)),
                     (lasp2_chunk_bwd_dkv, ins)):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        for a, b in zip(first, second):
            assert torch.equal(a, b), fn.__name__


@pytest.mark.parametrize("kernel", ["K1", "K2b"])
def test_chunk_split_refuses_a_short_workspace(gen, kernel):
    """Past one dk slice the ``simt`` C entries check the workspace they
    are handed: one slice short of what they split dk into raises, never
    writes past its end."""
    bh, s, dk, dv = 2, 64, 300, 40
    q, k, v, la, o, do, dst = _bwd_inputs(gen, bh, s, dk, dv, torch.float32)
    shape = list(lc.workspace(kernel, bh, s, dk, dv))
    shape[0] -= shape[0] // lc.dk_slices(dk)
    work = torch.zeros(shape, device="cuda")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        if kernel == "K1":
            lc.fwd_entry("simt", q, k, v, la, torch.empty_like(v),
                         torch.empty(bh, dk, dv, device="cuda"),
                         torch.empty(bh, device="cuda"), work=work)
        else:
            lc.bwd_dkv_entry("simt", q, k, v, la, o, do, dst,
                             torch.empty_like(q), torch.empty_like(v),
                             torch.empty(bh, s, device="cuda"), work=work)
    torch.cuda.synchronize()


@pytest.mark.parametrize("which", ["fwd", "dq"])
def test_chunk_fwd_and_dq_sm90_reject_misaligned_inputs(gen, which):
    """K1 and K2a read by TMA from a 16-byte aligned base: a bf16 input at
    dk = dv = 64 whose contiguous view starts elsewhere raises on the
    ``sm90`` route, and neither route launches (no fallback)."""
    q, k, v, la, _, do, _ = _bwd_inputs(gen, 2, 64, 64, 64, torch.bfloat16)
    flat = torch.zeros(k.numel() + 1, device="cuda", dtype=torch.bfloat16)
    k = flat[1:].view(k.shape)
    fn = lasp2_chunk_fwd if which == "fwd" else lasp2_chunk_bwd_dq
    before = (fn.launches, dict(fn.route_launches))
    with pytest.raises(ValueError, match="16-byte aligned"):
        if which == "fwd":
            lasp2_chunk_fwd(q, k, v, la)
        else:
            lasp2_chunk_bwd_dq(k, v, la, do)
    assert (fn.launches, dict(fn.route_launches)) == before


def test_chunk_dkv_sm90_rejects_misaligned_inputs(gen):
    """TMA reads from a 16-byte aligned base: a contiguous view that starts
    elsewhere is refused on the ``sm90`` route, never read wrong."""
    ins = list(_bwd_inputs(gen, 2, 64, 64, 64, torch.bfloat16))
    flat = torch.zeros(ins[0].numel() + 1, device="cuda",
                       dtype=torch.bfloat16)
    ins[0] = flat[1:].view(ins[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lasp2_chunk_bwd_dkv(*ins)


def test_bwd_wrappers_reject_what_the_kernels_do_not_take(gen):
    """Any width goes through (dk 24 among them); a dtype outside bf16 and
    fp32, a non-fp32 dM and non-contiguous inputs do not."""
    q = torch.zeros(2, 8, 24, device="cuda")
    v = torch.zeros(2, 8, 64, device="cuda")
    la = torch.zeros(2, 8, device="cuda")
    dst = torch.zeros(2, 24, 64, device="cuda")
    with pytest.raises(TypeError, match="one dtype"):
        lasp2_chunk_bwd(q.half(), q.half(), v.half(), la, v.half(),
                        v.half(), dst)
    with pytest.raises(TypeError, match="float32"):
        lasp2_chunk_bwd(q[..., :16].contiguous(), q[..., :16].contiguous(),
                        v, la, v, v, dst[:, :16].contiguous().half())
    with pytest.raises(ValueError, match="contiguous"):
        lasp2_chunk_bwd_dq(q[..., :16], v, la, v)


# ---------------------------------------------------------------------------
# Flash attention: K4, K5a, K5b against their plain versions.
# ---------------------------------------------------------------------------

def _flash_inputs(gen, b, hq, hkv, sq, sk, dh, dtype):
    q = torch.randn(b, hq, sq, dh, generator=gen, device="cuda") * 0.4
    k = torch.randn(b, hkv, sk, dh, generator=gen, device="cuda") * 0.4
    v = torch.randn(b, hkv, sk, dh, generator=gen, device="cuda") * 0.5
    do = torch.randn(b, hq, sq, dh, generator=gen, device="cuda")
    return tuple(x.to(dtype) for x in (q, k, v, do))


@pytest.mark.parametrize("sq,sk,hq,hkv", [(64, 64, 4, 4), (100, 100, 4, 2),
                                          (37, 200, 8, 1), (256, 256, 8, 2),
                                          (128, 300, 4, 4), (200, 200, 25, 5)])
@pytest.mark.parametrize("dh", [16, 64, 128, 8, 32, 100])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48), (False, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(gen, sq, sk, hq, hkv, dh, causal, window,
                                   dtype):
    """K4 (o, lse), K5a (dq) and K5b (dk, dv) over GQA ratios 1-8 and
    hymba's 25:5 (an odd head count), ragged
    lengths, sq != sk (q_offset = sk - sq), windows, fp32 (3e-4 for o, the
    reference's 1e-3 for gradients) and bf16 (``_close_bf16``), on both
    routes: bf16 at dh 64 and 128 through ``sm90`` (o, dk and dv with its
    rounding bound), the rest through ``simt``."""
    _check_flash(gen, 2, hq, hkv, sq, sk, dh, dtype,
                 dict(causal=causal, window=window))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,dh", [
    (2, 64, 8, 2048, 1601, 128), (2, 64, 8, 300, 1601, 128),
    (4, 64, 8, 512, 1601, 128), (4, 8, 8, 2048, 1500, 64),
    (4, 8, 8, 512, 1500, 64), (4, 8, 8, 1500, 1500, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_the_cross_shapes(gen, b, hq, hkv, sq, sk, dh,
                                           dtype):
    """The cross family's unmasked shapes (``chip_smoke.py``'s
    ``CROSS_FLASH``): the vision model's cross layer over 1601 image
    tokens at 2048, 300 and the serving prefill's 4 x 512 text queries
    (the default offset Sk − Sq negative, then positive), Whisper's cross
    layer over 1500 frames at 2048 and 4 x 512 queries and its encoder's
    1500 x 1500; ragged key tiles hold the only rows of their dk, dv."""
    _check_flash(gen, b, hq, hkv, sq, sk, dh, dtype, dict(causal=False))


def _check_flash(gen, b, hq, hkv, sq, sk, dh, dtype, kw):
    route = fl._route(dtype, dh)
    q, k, v, do = _flash_inputs(gen, b, hq, hkv, sq, sk, dh, dtype)
    counters = (fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    before = [c.route_launches[route] for c in counters]
    o, lse = fl.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    o_p, lse_p = fl.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1)
    extra = (None, None, None, None)
    if route == "sm90":
        extra = fl.sm90_rounding_bound(q, k, v, do, lse_p, delta, **kw)

    def close(got, want, fp32_tol, bound=None):
        if dtype == torch.bfloat16:
            _close_bf16(got, want, bound)
        else:
            _close(got, want, fp32_tol)

    assert o.dtype == dtype and lse.dtype == torch.float32
    close(o, o_p, 3e-4, extra[0])
    fully_masked = lse_p < -1e37          # rows that see no key
    _close(lse.masked_fill(fully_masked, 0), lse_p.masked_fill(
        fully_masked, 0), 1e-4)
    assert bool((lse[fully_masked] < -1e37).all())
    dq = fl.flash_attention_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    assert [c.route_launches[route] - n for c, n in zip(counters, before)] \
        == [1, 1, 1]
    dq_p = fl.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)
    dk_p, dv_p = fl.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                                  **kw)
    for g, w, bound in ((dq, dq_p, extra[1]), (dk, dk_p, extra[2]),
                        (dv, dv_p, extra[3])):
        assert g.dtype == dtype
        close(g, w, 1e-3, bound)


@pytest.mark.parametrize("q_offset,kv_len", [(64, 256), (0, 200), (-32, 256),
                                             (1000, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_explicit_offset_and_kv_len(gen, q_offset, kv_len,
                                                  dtype):
    """An explicit q_offset (ahead of, at, behind and past the keys) and a
    kv_len below Sk, causal with a 96-token window: fp32 through the
    ``simt`` route, bf16 (dh 64) through ``sm90``."""
    route = fl._route(dtype, 64)
    q, k, v, do = _flash_inputs(gen, 2, 4, 2, 128, 256, 64, dtype)
    kw = dict(causal=True, window=96, q_offset=q_offset, kv_len=kv_len)
    counters = (fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    before = [c.route_launches[route] for c in counters]
    o, lse = fl.flash_attention_fwd(q, k, v, **kw)
    o_p, lse_p = fl.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1)
    _close(lse.clamp(min=-1e30), lse_p.clamp(min=-1e30), 1e-4)
    dq = fl.flash_attention_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    assert [c.route_launches[route] - n for c, n in zip(counters, before)] \
        == [1, 1, 1]
    want = (fl.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fl.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                              **kw))
    if dtype == torch.float32:
        _close(o, o_p, 3e-4)
        for g, w in zip((dq, dk, dv), want):
            _close(g, w, 1e-3)
    else:
        b_o, *b_grads = fl.sm90_rounding_bound(q, k, v, do, lse_p, delta,
                                               **kw)
        _close_bf16(o, o_p, b_o)
        for g, w, bound in zip((dq, dk, dv), want, b_grads):
            _close_bf16(g, w, bound)
    if kv_len < 256:              # keys past kv_len get no gradient
        assert float(dk[:, :, kv_len:].abs().max()) == 0.0
        assert float(dv[:, :, kv_len:].abs().max()) == 0.0


def test_flash_autograd_launches_each_kernel_once(gen):
    """Autograd through ops.flash_attention_op on the card launches K4,
    K5a and K5b once each, on an odd length (ragged tiles, unpadded); bf16
    at dh 64 takes the ``sm90`` route of all three, never ``simt``."""
    from repro_torch.kernels import ops
    q, k, v, do = _flash_inputs(gen, 1, 4, 2, 300, 300, 64, torch.bfloat16)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counters = (fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    routed = counters
    before = [c.launches for c in counters]
    before_routes = [dict(c.route_launches) for c in routed]
    o = ops.flash_attention_op(*xs, causal=True, sliding_window=128)
    grads = torch.autograd.grad((o.float() * do.float()).sum(), xs)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1]
    for c, b in zip(routed, before_routes):
        assert c.route_launches["sm90"] - b["sm90"] == 1
        assert c.route_launches["simt"] == b["simt"]
    assert o.shape == q.shape and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("dh", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_simt_is_bitwise_repeatable(gen, dh, dtype):
    """K4, K5a and K5b on ``simt`` at the padded widths (dh 8 run at 16,
    32 at 32): each block owns its outputs and sums in a fixed order, two
    launches agree bit for bit."""
    q, k, v, do = _flash_inputs(gen, 2, 8, 2, 300, 300, dh, dtype)
    o, lse = fl.flash_attention_fwd(q, k, v, window=96)
    delta = (do.float() * o.float()).sum(-1)
    for fn, args in ((fl.flash_attention_fwd, (q, k, v)),
                     (fl.flash_attention_bwd_dq, (q, k, v, do, lse, delta)),
                     (fl.flash_attention_bwd_dkv,
                      (q, k, v, do, lse, delta))):
        first, second = fn(*args, window=96), fn(*args, window=96)
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        for a, b in zip(first, second):
            assert torch.equal(a, b), fn.__name__


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_dq_sm90_is_bitwise_repeatable(gen, dh):
    """K5a on the ``sm90`` route: each block owns its dq rows and sums its
    band in a fixed order, with no atomics: two launches on the same inputs
    agree bit for bit."""
    q, k, v, do = _flash_inputs(gen, 2, 8, 2, 512, 512, dh, torch.bfloat16)
    o, lse = fl.flash_attention_fwd(q, k, v, window=384)
    delta = (do.float() * o.float()).sum(-1)
    before = fl.flash_attention_bwd_dq.route_launches["sm90"]
    first = fl.flash_attention_bwd_dq(q, k, v, do, lse, delta, window=384)
    second = fl.flash_attention_bwd_dq(q, k, v, do, lse, delta, window=384)
    torch.cuda.synchronize()
    assert fl.flash_attention_bwd_dq.route_launches["sm90"] - before == 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_dkv_sm90_is_bitwise_repeatable(gen, dh):
    """K5b on the ``sm90`` route sums dk and dv over the GQA group in
    registers in a fixed order, with no atomics: two launches on the same
    inputs agree bit for bit."""
    q, k, v, do = _flash_inputs(gen, 2, 8, 2, 512, 512, dh, torch.bfloat16)
    o, lse = fl.flash_attention_fwd(q, k, v, window=384)
    delta = (do.float() * o.float()).sum(-1)
    before = fl.flash_attention_bwd_dkv.route_launches["sm90"]
    first = fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta, window=384)
    second = fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta, window=384)
    torch.cuda.synchronize()
    assert fl.flash_attention_bwd_dkv.route_launches["sm90"] - before == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_sm90_rejects_misaligned_inputs(gen):
    """TMA reads from a 16-byte aligned base: a contiguous view that starts
    elsewhere is refused on the ``sm90`` route, never read wrong."""
    flat = torch.zeros(1 * 2 * 8 * 64 + 1, device="cuda",
                       dtype=torch.bfloat16)
    q = flat[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.flash_attention_fwd(q, q, q)
    lse = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.flash_attention_bwd_dq(q, q, q, q, lse, lse)


def test_flash_wrappers_reject_what_the_kernels_do_not_take(gen):
    """Any dh from 1 to 128 goes through; a wider head, non-contiguous
    inputs, mixed dtypes and non-fp32 statistics do not."""
    q = torch.zeros(1, 2, 8, 160, device="cuda")         # dh 160
    with pytest.raises(ValueError, match="dh from 1 to 128"):
        fl.flash_attention_fwd(q, q, q)
    x = torch.zeros(1, 2, 64, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        fl.flash_attention_fwd(x.transpose(2, 3), x.transpose(2, 3),
                               x.transpose(2, 3))
    y = torch.zeros(1, 2, 8, 64, device="cuda")
    with pytest.raises(TypeError, match="one dtype"):
        fl.flash_attention_fwd(y, y.half(), y.half())
    lse = torch.zeros(1, 2, 8, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        fl.flash_attention_bwd_dq(y, y, y, y, lse.half(), lse)


def test_chunk_bwd_sm90_with_the_sp_state_cotangent(gen):
    """Under sequence parallelism K2a and K2b get what no one-device path
    gives them: a nonzero end-state cotangent (the faithful backward's
    decayed suffix sum of the later chunks' dM). At the chunk shape of two
    ranks over 2048 tokens (BH 64 × C 1024 × 128, bf16, ``sm90``), with
    resets and decays, against the fp32 plain passes at the limits of
    ``test_chunk_bwd_kernels_match_plain``."""
    s = 1024
    ins = _bwd_inputs(gen, 64, s, 128, 128, torch.bfloat16)
    assert float(ins[-1].abs().max()) > 0           # dstate
    before = [fn.route_launches["sm90"]
              for fn in (lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv)]
    got = lasp2_chunk_bwd(*ins)
    torch.cuda.synchronize()
    assert [fn.route_launches["sm90"] - n for fn, n in zip(
        (lasp2_chunk_bwd_dq, lasp2_chunk_bwd_dkv), before)] == [1, 1]
    want = lasp2_chunk_bwd_plain(*ins, block_size=pick_block(s, 128))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 4e-2)
    slack = s * 2.0 ** -24 * float(want[3].abs().max())
    torch.testing.assert_close(got[3], want[3], rtol=1e-3,
                               atol=1e-3 + slack)


def _flash_sm90_case(gen, b, h, sq, sk, q_offset):
    """K4, K5a and K5b on ``sm90`` (bf16, dh 128, causal, window 2048)
    against the plain versions at the limits of
    ``test_flash_kernels_explicit_offset_and_kv_len``."""
    q, k, v, do = _flash_inputs(gen, b, h, h, sq, sk, 128, torch.bfloat16)
    kw = dict(causal=True, window=2048, q_offset=q_offset, kv_len=sk)
    counters = (fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    before = [c.route_launches["sm90"] for c in counters]
    o, lse = fl.flash_attention_fwd(q, k, v, **kw)
    o_p, lse_p = fl.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o_p.float()).sum(-1)
    _close(lse, lse_p, 1e-4)
    dq = fl.flash_attention_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fl.flash_attention_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    assert [c.route_launches["sm90"] - n for c, n in zip(counters, before)] \
        == [1, 1, 1]
    want = (fl.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
            *fl.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                              **kw))
    b_o, *b_grads = fl.sm90_rounding_bound(q, k, v, do, lse_p, delta, **kw)
    _close_bf16(o, o_p, b_o)
    for g, w, bound in zip((dq, dk, dv), want, b_grads):
        _close_bf16(g, w, bound)


def test_flash_sm90_at_the_sp_context_shape(gen):
    """Under sequence parallelism a softmax layer attends with its rank's
    chunk of queries (sq = C = 1024) over the gathered keys (sk = W·C =
    2048) at q_offset t·C = 1024, window 2048, dh 128."""
    _flash_sm90_case(gen, 4, 16, 1024, 2048, 1024)


def test_flash_sm90_at_the_ulysses_shape(gen):
    """Under the "ulysses" strategy at W 2 a softmax layer attends with
    half its heads (8 of 16) over the whole sequence (S 2048) at q_offset
    0, window 2048, dh 128."""
    _flash_sm90_case(gen, 4, 8, 2048, 2048, 0)
