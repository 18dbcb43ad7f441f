"""Port vs reference: the chunk backward (K2a and K2b) and gradients
through ``ops.linear_attention_op``.

The same numpy inputs (from a seed) go through ``repro`` and
``repro_torch``. The reference's Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them; the port's wrappers take their plain
PyTorch versions on CPU tensors. Tolerance: gradients 1e-3 (the
reference's ``GRAD_TOL``, ``tests/test_kernels.py:15``); bf16 inputs 4e-2
(its bf16 kernel tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_attention as jla
from repro.kernels import ops as jops
from repro.kernels.lasp2_chunk import lasp2_chunk_bwd as j_chunk_bwd
from repro.kernels.lasp2_chunk import lasp2_chunk_fwd as j_chunk_fwd
from repro_torch.core import linear_attention as tla
from repro_torch.kernels import lasp2_chunk as tk
from repro_torch.kernels import ops as tops

GRAD_TOL = 1e-3
BF16_TOL = 4e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The SMOKE shapes are tiny: one intra-op thread is fastest, and the
    suite's parallel workers share the cores (with a thread per core in
    every worker, each small op's thread barrier thrashes)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(seed, lead, s, dk, dv, la_kind):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((*lead, s, dk)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((*lead, s, dk)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((*lead, s, dv)) * 0.5).astype(np.float32)
    la = np.zeros((*lead, s), np.float32)
    if la_kind in ("decay", "reset"):
        la = (-np.abs(rng.standard_normal((*lead, s))) * 0.05).astype(
            np.float32)
    if la_kind == "reset":
        la[..., s // 2 - 5] = jla.RESET_LOG_A      # mid-block resets
        la[..., 3] = jla.RESET_LOG_A
    return q, k, v, la


def _cotangents(seed, lead, s, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*lead, s, dv)).astype(np.float32),
            rng.standard_normal((*lead, dk, dv)).astype(np.float32),
            rng.standard_normal(lead).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _close(got, want, tol, what):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("dk,dv", [(16, 16), (32, 32), (16, 32)])
@pytest.mark.parametrize("la_kind", ["zero", "decay", "reset"])
def test_chunk_bwd_plain_matches_reference_kernels(s, dk, dv, la_kind):
    """Both passes, block by block, against the Pallas backward kernels
    (interpret mode) on the same o, dO and dM."""
    q, k, v, la = _inputs(s + dk + dv, (4,), s, dk, dv, la_kind)
    do, dst, _ = _cotangents(7, (4,), s, dk, dv)
    jo, _, _ = j_chunk_fwd(*map(jnp.asarray, (q, k, v, la)), block_size=64,
                           interpret=True)
    want = j_chunk_bwd(*map(jnp.asarray, (q, k, v, la)), jo,
                       jnp.asarray(do), jnp.asarray(dst), block_size=64,
                       interpret=True)
    got = tk.lasp2_chunk_bwd_plain(*map(_t, (q, k, v, la, jo, do, dst)),
                                   block_size=64)
    for name, g, w in zip(("dq", "dk", "dv", "dla"), got, want):
        _close(g, w, GRAD_TOL, name)
    # the wrapper takes the same plain passes on CPU tensors
    via = tk.lasp2_chunk_bwd(*map(_t, (q, k, v, la, jo, do, dst)),
                             block_size=64)
    for g, w in zip(via, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _grads_port(inputs, cot, *, dtype=torch.float32, block_size=64,
                requires=(0, 1, 2, 3)):
    q, k, v, la = inputs
    xs = [_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(la)]
    for i in requires:
        xs[i].requires_grad_(True)
    o, st, ld = tops.linear_attention_op(*xs, block_size=block_size)
    co, cs, cl = map(_t, cot)
    loss = (o.float() * co).sum() + (st * cs).sum() + (ld * cl).sum()
    return torch.autograd.grad(loss, [xs[i] for i in requires])


def _grads_ref(inputs, cot, *, dtype=jnp.float32, block_size=64,
               argnums=(0, 1, 2, 3)):
    co, cs, cl = map(jnp.asarray, cot)

    def loss(q, k, v, la):
        o, st, ld = jops.linear_attention_op(q, k, v, la,
                                             block_size=block_size,
                                             backend="interpret")
        return (jnp.sum(o.astype(jnp.float32) * co) + jnp.sum(st * cs)
                + jnp.sum(ld * cl))

    q, k, v, la = inputs
    args = (jnp.asarray(q, dtype), jnp.asarray(k, dtype),
            jnp.asarray(v, dtype), jnp.asarray(la))
    return jax.grad(loss, argnums=argnums)(*args)


@pytest.mark.parametrize("la_kind", ["zero", "decay", "reset"])
def test_op_grads_match_reference(la_kind):
    """Autograd through the port's op (LASP2Chunk) == jax.grad through the
    reference op (Pallas custom_vjp in interpret mode), pulling on all
    three outputs; with log a = 0 this includes d log_a at log_a = 0."""
    inputs = _inputs(11, (2, 3), 256, 32, 48 if la_kind == "zero" else 32,
                     la_kind)
    s, dk, dv = 256, 32, inputs[2].shape[-1]
    cot = _cotangents(12, (2, 3), s, dk, dv)
    for name, g, w in zip("q k v log_a".split(), _grads_port(inputs, cot),
                          _grads_ref(inputs, cot)):
        _close(g, w, GRAD_TOL, f"d{name}")


def test_op_grads_state_cotangent_only():
    """Pulling only on the end-of-chunk state (the Alg. 4 dM path): dq is
    exactly 0, the rest matches."""
    inputs = _inputs(13, (2, 3), 128, 32, 32, "decay")
    co, cs, cl = _cotangents(14, (2, 3), 128, 32, 32)
    cot = (np.zeros_like(co), cs, np.zeros_like(cl))
    got = _grads_port(inputs, cot)
    assert float(got[0].abs().max()) == 0.0
    for name, g, w in zip("q k v log_a".split(), got,
                          _grads_ref(inputs, cot)):
        _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("s", [97, 130])
def test_op_grads_padding_path(s):
    """Lengths that are no block multiple differentiate through the
    zero-padding path (``F.pad`` and the slice back to S)."""
    inputs = _inputs(15 + s, (2, 3), s, 16, 16, "decay")
    co, cs, _ = _cotangents(16, (2, 3), s, 16, 16)
    cot = (co, cs, np.zeros((2, 3), np.float32))
    for name, g, w in zip("q k v log_a".split(), _grads_port(inputs, cot),
                          _grads_ref(inputs, cot)):
        assert g.shape == w.shape
        _close(g, w, GRAD_TOL, f"d{name}")


def test_op_grads_bf16_inputs():
    """bf16 q/k/v: gradients come back in bf16, fp32 math inside."""
    inputs = _inputs(17, (2, 3), 128, 32, 32, "decay")
    cot = _cotangents(18, (2, 3), 128, 32, 32)
    got = _grads_port(inputs, cot, dtype=torch.bfloat16, requires=(0, 1, 2))
    want = _grads_ref(inputs, cot, dtype=jnp.bfloat16, argnums=(0, 1, 2))
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close(g, w, BF16_TOL, f"d{name}")


def test_op_grads_match_port_oracle():
    """An independent derivation on the port side alone: the op's
    gradients (both plain passes) against autograd of the O(S)
    sequential oracle."""
    inputs = _inputs(19, (2,), 96, 16, 16, "reset")
    cot = _cotangents(20, (2,), 96, 16, 16)
    got = _grads_port(inputs, cot, block_size=32)
    xs = [_t(x).requires_grad_(True) for x in inputs]
    out = tla.sequential_oracle(*xs)
    co, cs, cl = map(_t, cot)
    loss = (out.o * co).sum() + (out.state * cs).sum() \
        + (out.log_decay * cl).sum()
    for name, g, w in zip("q k v log_a".split(), got,
                          torch.autograd.grad(loss, xs)):
        _close(g, w.numpy(), GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("la_kind", ["zero", "reset"])
def test_block_summary_and_chunk_summaries_match_reference(la_kind):
    q, k, v, la = _inputs(21, (2, 3), 128, 16, 32, la_kind)
    jm, ja = jla.block_summary(jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(la))
    tm, ta = tla.block_summary(_t(k), _t(v), _t(la))
    _close(tm, jm, 3e-4, "block state")
    _close(ta, ja, 1e-5, "block log decay")
    jm, ja = jla.chunk_summaries(jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(la), block_size=32)
    tm, ta = tla.chunk_summaries(_t(k), _t(v), _t(la), block_size=32)
    _close(tm, jm, 3e-4, "chunk state")
    _close(ta, ja, 1e-5, "chunk log decay")
    # and they are the state and log decay of the full scan
    full = tla.chunk_scan(_t(q), _t(k), _t(v), _t(la), block_size=32)
    _close(tm, full.state.numpy(), 3e-4, "vs chunk_scan state")
