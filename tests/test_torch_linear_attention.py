"""Port vs reference: linear-attention math and the kernel ops.

The same numpy inputs (from a seed) go through ``repro`` and
``repro_torch``. On the reference side the Pallas kernels run in interpret
mode, as ``tests/test_kernels.py`` runs them; on the port side CPU tensors
take the kernels' plain PyTorch versions. Tolerances are the reference's
kernel tolerances (``tests/test_kernels.py:14``): 3e-4 fp32, 4e-2 bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_attention as jla
from repro.kernels import ops as jops
from repro.kernels.lasp2_chunk import lasp2_chunk_fwd as j_chunk_fwd
from repro.kernels.lasp2_decode import lasp2_decode_step as j_decode_step
from repro.kernels.ref import linear_attention_ref as j_ref
from repro_torch.core import linear_attention as tla
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import linear_attention_ref as t_ref

TOL = {"float32": 3e-4, "bfloat16": 4e-2}
LD_TOL = 1e-5


def _inputs(seed, lead, s, dk, dv, la_kind):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((*lead, s, dk)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((*lead, s, dk)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((*lead, s, dv)) * 0.5).astype(np.float32)
    la = np.zeros((*lead, s), np.float32)
    if la_kind in ("decay", "decay+reset"):
        la = (-np.abs(rng.standard_normal((*lead, s))) * 0.03).astype(
            np.float32)
    if la_kind in ("reset", "decay+reset"):
        la[..., s // 2 - 3] = jla.RESET_LOG_A      # mid-block resets
        la[..., 1] = jla.RESET_LOG_A
    return q, k, v, la


def _jax(x, dtype="float32"):
    return jnp.asarray(x).astype(dtype)


def _torch(x, dtype="float32"):
    return torch.from_numpy(np.array(x)).to(getattr(torch, dtype))


def _close(got, want, tol, what):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).float()) if isinstance(
            got, torch.Tensor) else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def test_pick_block_matches_reference():
    for s in list(range(1, 300)) + [384, 448, 511, 512, 1000, 4096]:
        for pref in (16, 32, 64, 128, 256):
            assert tla.pick_block(s, pref) == jla.pick_block(s, pref), \
                (s, pref)


@pytest.mark.parametrize("la_kind", ["zero", "decay+reset"])
def test_sequential_oracle_matches_reference(la_kind):
    q, k, v, la = _inputs(0, (2, 3), 24, 16, 8, la_kind)
    j = jla.sequential_oracle(*(map(_jax, (q, k, v, la))))
    t = tla.sequential_oracle(*(map(_torch, (q, k, v, la))))
    _close(t.o, j.o, TOL["float32"], "o")
    _close(t.state, j.state, TOL["float32"], "state")
    _close(t.log_decay, j.log_decay, LD_TOL, "log_decay")


@pytest.mark.parametrize("s,block", [(64, 16), (96, 32), (128, 128)])
@pytest.mark.parametrize("la_kind", ["zero", "decay", "decay+reset"])
def test_chunk_scan_matches_reference(s, block, la_kind):
    q, k, v, la = _inputs(1, (2, 3), s, 16, 32, la_kind)
    j = jla.chunk_scan(*(map(_jax, (q, k, v, la))), block_size=block)
    t = tla.chunk_scan(*(map(_torch, (q, k, v, la))), block_size=block)
    _close(t.o, j.o, TOL["float32"], "o")
    _close(t.state, j.state, TOL["float32"], "state")
    _close(t.log_decay, j.log_decay, LD_TOL, "log_decay")
    # and the port's chunked form equals its own sequential oracle
    o = tla.sequential_oracle(*(map(_torch, (q, k, v, la))))
    _close(t.o, o.o, TOL["float32"], "o vs oracle")


def test_recurrent_step_matches_reference():
    q, k, v, la = _inputs(2, (2, 3), 6, 16, 32, "decay")
    rng = np.random.default_rng(3)
    m0 = rng.standard_normal((2, 3, 16, 32)).astype(np.float32)
    ld0 = np.full((2, 3), -1.5, np.float32)
    jm, jld = _jax(m0), _jax(ld0)
    tm, tld = _torch(m0), _torch(ld0)
    for t in range(q.shape[-2]):
        jo, jm, jld = jla.recurrent_step(
            _jax(q[..., t, :]), _jax(k[..., t, :]), _jax(v[..., t, :]),
            _jax(la[..., t]), state=jm, log_decay=jld)
        to, tm, tld = tla.recurrent_step(
            _torch(q[..., t, :]), _torch(k[..., t, :]), _torch(v[..., t, :]),
            _torch(la[..., t]), state=tm, log_decay=tld)
        _close(to, jo, TOL["float32"], f"o step {t}")
    _close(tm, jm, TOL["float32"], "state")
    _close(tld, jld, LD_TOL, "log_decay")


def test_linear_attention_ref_matches_reference():
    q, k, v, la = _inputs(4, (3,), 40, 16, 16, "decay+reset")
    jo, jst = j_ref(*(map(_jax, (q, k, v, la))))
    to, tst = t_ref(*(map(_torch, (q, k, v, la))))
    _close(to, jo, TOL["float32"], "o")
    _close(tst, jst, TOL["float32"], "state")


@pytest.mark.parametrize("s", [64, 128, 37])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("la_kind", ["zero", "decay", "reset"])
def test_linear_attention_op_matches_pallas_interpret(s, d, dtype, la_kind):
    """Port op (plain path on CPU) vs the reference's Pallas chunk kernel
    in interpret mode, called directly and through its op."""
    b, h = 2, 2
    q, k, v, la = _inputs(5, (b, h), s, d, d, la_kind)
    to, tst, tld = tops.linear_attention_op(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), _torch(la),
        block_size=128)
    assert to.dtype == getattr(torch, dtype) and tst.dtype == torch.float32
    jo, jst, jld = jops.linear_attention_op(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), _jax(la),
        block_size=128, backend="interpret")
    t = TOL[dtype]
    _close(to, jo, t, "o vs op(interpret)")
    _close(tst, jst, t, "state vs op(interpret)")
    _close(tld, jld, LD_TOL, "log_decay vs op(interpret)")
    # the kernel itself, on the block the op's policy picks (min(s, 128)
    # for these lengths)
    flat = lambda x, dt: _jax(x.reshape(b * h, *x.shape[2:]), dt)
    ko, kst, kld = j_chunk_fwd(flat(q, dtype), flat(k, dtype),
                               flat(v, dtype), flat(la, "float32"),
                               block_size=min(s, 128), interpret=True)
    _close(to.reshape(b * h, s, d), ko, t, "o vs lasp2_chunk_fwd")
    _close(tst.reshape(b * h, d, d), kst, t, "state vs lasp2_chunk_fwd")
    _close(tld.reshape(b * h), kld, LD_TOL, "log_decay vs lasp2_chunk_fwd")


@pytest.mark.parametrize("dk,dv", [(16, 16), (32, 64)])
@pytest.mark.parametrize("la_kind", ["zero", "decay"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_decode_op_matches_pallas_interpret(dk, dv, la_kind, dtype):
    """Prefill the first tokens with the chunk op, then decode the rest one
    step at a time: port ``linear_decode_op`` vs the reference's Pallas
    decode kernel in interpret mode, and both vs the sequential oracle."""
    b, h, s, split = 2, 2, 20, 14
    q, k, v, la = _inputs(6, (b, h), s, dk, dv, la_kind)
    ref = jla.sequential_oracle(*(map(_jax, (q, k, v, la))))
    _, tst, tld = tops.linear_attention_op(
        *(_torch(x[..., :split, :], dtype) for x in (q, k, v)),
        _torch(la[..., :split]))
    _, jst, jld = jops.linear_attention_op(
        *(_jax(x[..., :split, :], dtype) for x in (q, k, v)),
        _jax(la[..., :split]), backend="interpret")
    jst, jld = jst.reshape(b * h, dk, dv), jld.reshape(b * h)
    t = TOL[dtype]
    for i in range(split, s):
        to, tst, tld = tops.linear_decode_op(
            *(_torch(x[..., i, :], dtype) for x in (q, k, v)),
            _torch(la[..., i]), tst, tld)
        jo, jst, jld = j_decode_step(
            *(_jax(x[..., i, :].reshape(b * h, -1), dtype)
              for x in (q, k, v)),
            _jax(la[..., i].reshape(b * h)), jst, jld, interpret=True)
        assert to.dtype == torch.float32
        _close(to.reshape(b * h, dv), jo, t, f"o step {i}")
        _close(to, ref.o[..., i, :], t, f"o vs oracle step {i}")
    _close(tst.reshape(b * h, dk, dv), jst, t, "state")
    _close(tst, ref.state, t, "state vs oracle")
    _close(tld.reshape(b * h), jld, LD_TOL, "log_decay")


@pytest.mark.parametrize("kind", ["identity", "elu1", "silu", "relu",
                                  "taylor"])
def test_feature_map_matches_reference(kind):
    x = np.random.default_rng(7).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    _close(tla.feature_map(_torch(x), kind), jla.feature_map(_jax(x), kind),
           1e-6, kind)


@pytest.mark.parametrize("kind", ["none", "retention", "lightning"])
def test_decay_log_a_matches_reference(kind):
    _close(tla.decay_log_a(kind, heads=6, s=3),
           jla.decay_log_a(kind, heads=6, s=3), 1e-6, kind)
