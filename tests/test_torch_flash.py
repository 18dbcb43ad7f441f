"""Port vs reference: flash attention (K4 forward, K5a/K5b backward) and
``ops.flash_attention_op``.

The same numpy inputs (from a seed) go through ``repro`` and
``repro_torch``. The reference's Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them; the port's wrappers take their plain
PyTorch versions on CPU tensors. Tolerances: o and lse 3e-4 in fp32 and
4e-2 in bf16 (the reference's kernel tolerances,
``tests/test_kernels.py:14``); gradients 1e-3 (its ``GRAD_TOL``), 4e-2 for
bf16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lasp2h import _softmax_attend as j_softmax_attend
from repro.core.lasp2h import causal_mask as j_causal_mask
from repro.core.lasp2h import ring_decode_attention as j_ring_decode
from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro_torch.core import lasp2h as tlasp2h
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import flash_attention_ref as t_flash_ref

TOL = {"float32": 3e-4, "bfloat16": 4e-2}
GRAD_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is fastest while the suite's
    parallel workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _case(seed, b, hq, hkv, sq, sk, dh):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, sq, dh)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((b, hkv, sk, dh)) * 0.4).astype(np.float32)
    v = (rng.standard_normal((b, hkv, sk, dh)) * 0.5).astype(np.float32)
    co = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    return q, k, v, co


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# Forward: the plain K4 against the reference's oracle and Pallas kernel.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,sk,hq,hkv,dh", [
    (256, 256, 4, 2, 64), (128, 128, 8, 1, 64), (256, 256, 4, 4, 128),
    (128, 256, 4, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 64)])
def test_plain_fwd_matches_reference_oracle(sq, sk, hq, hkv, dh, dtype,
                                            causal, window):
    """The sweep of ``test_flash_kernel_sweep`` (tests/test_kernels.py:39):
    the plain K4 and the port's oracle against the reference's oracle."""
    q, k, v, _ = _case(0, 2, hq, hkv, sq, sk, dh)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = j_flash_ref(jq, jk, jv, causal=causal, sliding_window=window)
    o, lse = tflash.flash_attention_fwd(tq, tk, tv, causal=causal,
                                        window=window)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert lse.shape == (2, hq, sq)
    _close(o, want, TOL[dtype], "plain K4 o")
    _close(t_flash_ref(tq, tk, tv, causal=causal, sliding_window=window),
           want, TOL[dtype], "port oracle")


@pytest.mark.parametrize("sq,sk,hq,hkv,causal,window,q_offset", [
    (128, 128, 4, 2, True, None, None),
    (64, 192, 4, 1, True, 96, None),
    (128, 128, 4, 4, False, 64, None),
    (64, 256, 4, 2, True, None, 64),
])
def test_plain_fwd_o_and_lse_match_pallas_kernel(sq, sk, hq, hkv, causal,
                                                 window, q_offset):
    """o and lse of the plain K4 against the reference's ``_fwd_call`` in
    interpret mode (which returns both), explicit offsets included."""
    q, k, v, _ = _case(1, 2, hq, hkv, sq, sk, 32)
    off = sk - sq if q_offset is None else q_offset
    jo, jlse = jflash._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.full((1, 1), off, jnp.int32), causal=causal,
        sliding_window=window, scale=32 ** -0.5, q_offset=off, kv_len=sk,
        block_q=64, block_k=64, interpret=True)
    o, lse = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        window=window, q_offset=off)
    _close(o, jo, 3e-4, "o")
    _close(lse, jlse, 3e-4, "lse")


def test_plain_fwd_fully_masked_rows_match_pallas_kernel():
    """Rows that see no key (an offset behind the keys, causal) keep the
    kernel's fill: o = 0 and lse = mask_value + log(1e-30)."""
    q, k, v, _ = _case(2, 1, 2, 2, 64, 64, 16)
    off = -32
    jo, jlse = jflash._fwd_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.full((1, 1), off, jnp.int32), causal=True, sliding_window=None,
        scale=0.25, q_offset=off, kv_len=64, block_q=64, block_k=64,
        interpret=True)
    o, lse = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), q_offset=off)
    assert float(o[:, :, :32].abs().max()) == 0.0
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-6)
    _close(o, jo, 3e-4, "o")
    assert tflash.mask_value(torch.float32) == jflash.mask_value(jnp.float32)


@pytest.mark.parametrize("sq,sk,window", [(128, 256, None), (64, 256, None),
                                          (128, 256, 96)])
def test_offset_op_matches_reference_mask(sq, sk, window):
    """Twin of ``test_flash_offset_matches_xla_mask`` (tests/test_kernels.py
    :278): sq < sk puts query row i at (sk - sq) + i; the port's op, its
    plain ``_softmax_attend`` under ``causal_mask``, and the reference's
    Pallas op agree."""
    q, k, v, _ = _case(3, 2, 4, 2, sq, sk, 64)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = jops.flash_attention_op(jq, jk, jv, causal=True,
                                   sliding_window=window, block_q=64,
                                   block_k=64, backend="interpret")
    _close(tops.flash_attention_op(tq, tk, tv, causal=True,
                                   sliding_window=window), want, 3e-4, "op")
    mask = tlasp2h.causal_mask(sq, sk, sk - sq, sliding_window=window)
    _close(tlasp2h._softmax_attend(tq, tk, tv, scale=64 ** -0.5,
                                   mask=mask[None, None]), want, 3e-4,
           "_softmax_attend")
    jmask = j_causal_mask(sq, sk, sk - sq, sliding_window=window)
    _close(tlasp2h._softmax_attend(tq, tk, tv, scale=64 ** -0.5,
                                   mask=mask[None, None]),
           j_softmax_attend(jq, jk, jv, scale=64 ** -0.5,
                            mask=jmask[None, None]), 3e-4, "vs reference")


# ---------------------------------------------------------------------------
# Backward: FlashAttention (plain K5a/K5b) against jax.grad through the
# reference's custom_vjp (Pallas in interpret mode).
# ---------------------------------------------------------------------------

def _grads(q, k, v, co, dtype, *, causal, window, q_offset=None):
    """(reference grads through the interpret-mode custom_vjp, port grads
    through ``ops.flash_attention_op``)."""
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jco = jnp.asarray(co)

    def jloss(a, b, c):
        o = jops.flash_attention_op(a, b, c, causal=causal,
                                    sliding_window=window,
                                    backend="interpret", block_q=64,
                                    block_k=64, q_offset=q_offset)
        return jnp.sum(o.astype(jnp.float32) * jco)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.requires_grad_(True) for x in (tq, tk, tv)]
    o = tops.flash_attention_op(*leaves, causal=causal,
                                sliding_window=window, q_offset=q_offset)
    tg = torch.autograd.grad((o.float() * torch.from_numpy(co)).sum(),
                             leaves)
    return jg, tg


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64)])
def test_grads_match_reference_custom_vjp(hq, hkv, causal, window):
    q, k, v, co = _case(4, 2, hq, hkv, 128, 128, 32)
    jg, tg = _grads(q, k, v, co, "float32", causal=causal, window=window)
    for name, t, j in zip("qkv", tg, jg):
        _close(t, j, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("sq,sk,window,q_offset", [
    (64, 192, None, None), (64, 256, 96, None), (64, 128, None, 32)])
def test_grads_offset_shapes(sq, sk, window, q_offset):
    """sq != sk with the default offset sk - sq, and an explicit one."""
    q, k, v, co = _case(5, 2, 4, 2, sq, sk, 32)
    jg, tg = _grads(q, k, v, co, "float32", causal=True, window=window,
                    q_offset=q_offset)
    for name, t, j in zip("qkv", tg, jg):
        _close(t, j, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("sq,sk", [(100, 100), (129, 257)])
def test_grads_awkward_lengths(sq, sk):
    """Twin of ``test_flash_grads_awkward_lengths`` (:378): odd lengths, which
    the reference pads to its block and the port takes unpadded, forward
    and backward."""
    q, k, v, co = _case(6, 1, 4, 2, sq, sk, 32)
    jg, tg = _grads(q, k, v, co, "float32", causal=True, window=None)
    assert tg[0].shape == (1, 4, sq, 32) and tg[1].shape == (1, 2, sk, 32)
    for name, t, j in zip("qkv", tg, jg):
        _close(t, j, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("sq,sk", [(80, 50), (30, 100), (75, 75)])
def test_cross_shapes_noncausal_fwd_and_grads(sq, sk):
    """The cross-attention and encoder shapes at dh 16, GQA 2:1, fp32:
    ``causal=False`` with Sq > Sk (the default offset Sk − Sq is
    negative), Sq < Sk, and a square ragged length (the encoder's), every
    length off the 64-block. The port's op against the reference's
    interpret-mode op: o, then dq, dk, dv."""
    q, k, v, co = _case(8, 2, 4, 2, sq, sk, 16)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = jops.flash_attention_op(jq, jk, jv, causal=False, block_q=64,
                                   block_k=64, backend="interpret")
    got = tops.flash_attention_op(*(torch.from_numpy(x) for x in (q, k, v)),
                                  causal=False)
    _close(got, want, TOL["float32"], "o")
    jg, tg = _grads(q, k, v, co, "float32", causal=False, window=None)
    for name, t, j in zip("qkv", tg, jg):
        _close(t, j, GRAD_TOL, f"d{name}")


def test_grads_bf16_inputs():
    """bf16 q/k/v: gradients come back in bf16 from fp32 math."""
    q, k, v, co = _case(7, 2, 4, 2, 128, 128, 64)
    jg, tg = _grads(q, k, v, co, "bfloat16", causal=True, window=None)
    for name, t, j in zip("qkv", tg, jg):
        assert t.dtype == torch.bfloat16
        _close(t, j, 4e-2, f"d{name}")


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, None), (True, 48, None), (False, 40, None),
    (True, None, 50)])
def test_plain_passes_match_autograd_of_forward(causal, window, q_offset):
    """The plain K5a and K5b, called directly with the saved lse and delta,
    equal torch autograd through the plain K4 (GQA 3:1, sq != sk)."""
    q, k, v, co = _case(8, 1, 6, 2, 70, 90, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = tflash.flash_attention_fwd_plain(tq, tk, tv, **kw)
    do = torch.from_numpy(co)
    want = torch.autograd.grad((o * do).sum(), (tq, tk, tv))
    o, lse = o.detach(), lse.detach()
    delta = (do * o).sum(-1)
    dq = tflash.flash_attention_bwd_dq(tq.detach(), tk.detach(), tv.detach(),
                                       do, lse, delta, **kw)
    dk, dv = tflash.flash_attention_bwd_dkv(tq.detach(), tk.detach(),
                                            tv.detach(), do, lse, delta, **kw)
    for name, got, w in zip("qkv", (dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   msg=f"d{name}")


def test_wrappers_check_shapes():
    x = torch.zeros((1, 4, 8, 16))
    with pytest.raises(ValueError, match="Hkv"):
        tflash.flash_attention_fwd(x, x[:, :3], x[:, :3])
    with pytest.raises(ValueError, match="kv_len"):
        tflash.flash_attention_fwd(x, x, x, kv_len=9)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention_fwd(x, x, x, window=0)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="want dO"):
        tflash.flash_attention_bwd_dq(x, x, x, x[:, :, :4], lse, lse)


@pytest.mark.parametrize("hq,hkv,window", [(4, 4, None), (8, 2, 5),
                                           (4, 1, None)])
def test_ring_decode_attention_matches_reference(hq, hkv, window):
    """One token against a ring of 12 slots: unwritten slots (-1), slots
    ahead of a row's position, rows at different positions, GQA."""
    rng = np.random.default_rng(9)
    q = (rng.standard_normal((3, hq, 1, 16)) * 0.5).astype(np.float32)
    kc, vc = ((rng.standard_normal((3, hkv, 12, 16)) * 0.5).astype(
        np.float32) for _ in range(2))
    kpos = np.array([np.arange(12) - 4, np.arange(12) + 7,
                     np.r_[np.arange(12, 17), -np.ones(7)]], np.int32)
    qpos = np.array([6, 20, 16], np.int32)
    want = j_ring_decode(*(jnp.asarray(x) for x in (q, kc, vc, kpos, qpos)),
                         sliding_window=window)
    got = tlasp2h.ring_decode_attention(
        *(torch.from_numpy(x) for x in (q, kc, vc, kpos, qpos)),
        sliding_window=window)
    _close(got, want, 3e-4, "ring decode")
