"""Flash attention's kernel routes, the build's source hashing, and the
limit the ``sm90`` route is held to, on the CPU.

* ``_route`` is a fixed table, the same for K4, K5a and K5b: bf16 at dh 64
  and 128 go to the tensor-core kernels (``sm90``), fp32 at any dh and bf16
  at dh 16 to the CUDA-core kernels (``simt``).
* ``_build._lib_path`` names a library by its source, the shared headers
  (``csrc/*.cuh``) and the flags, so a changed header rebuilds the kernels
  that include it.
* The ``sm90`` kernels round P (and dS) to bf16 inside their products where
  the reference keeps fp32. Their card tests add ``sm90_rounding_bound``
  (2^-8 times the same products over absolute values) to the bf16 limit;
  here the plain formulas with P and dS rounded to bf16 stay inside that
  bound (o, dq, dk and dv) over shapes with sq != sk, windows, GQA 1, 2, 4
  and 8, and dh 64 and 128.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fl


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"), (torch.float32, 16, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
def test_route_table(dtype, dh, route):
    assert fl._route(dtype, dh) == route
    assert route in fl.ROUTES


def test_cpu_tensors_take_no_route():
    """On the CPU the wrappers run their plain versions: no launch counter,
    total or per route, moves."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(
        rng.standard_normal((1, 2, 40, 64)).astype(np.float32)).bfloat16()
        for _ in range(4))
    counters = (fl.flash_attention_fwd, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    before = [(c.launches, dict(c.route_launches)) for c in counters]
    o, lse = fl.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    fl.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    fl.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert [(c.launches, dict(c.route_launches)) for c in counters] == before


def test_lib_path_hashes_headers(tmp_path, monkeypatch):
    """The library name moves with the source and with every header under
    the source's directory, and stays put when nothing changed."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    src, header = tmp_path / "k.cu", tmp_path / "sm90.cuh"
    src.write_text('#include "sm90.cuh"\nint f() { return 1; }\n')
    header.write_text("#pragma once\n")
    first = _build._lib_path(src)
    assert _build._lib_path(src) == first
    header.write_text("#pragma once\n// changed\n")
    second = _build._lib_path(src)
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "other.cuh").write_text("#pragma once\n")
    third = _build._lib_path(src)
    assert third != second
    src.write_text('#include "sm90.cuh"\nint f() { return 2; }\n')
    assert _build._lib_path(src) != third


def _bf16_inputs(seed, b, hq, hkv, sq, sk, dh):
    """q, k, v, dO as the card's kernels see them: bf16 values."""
    rng = np.random.default_rng(seed)
    shapes = ((b, hq, sq, dh), (b, hkv, sk, dh), (b, hkv, sk, dh),
              (b, hq, sq, dh))
    scales = (0.4, 0.4, 0.5, 1.0)
    return tuple(torch.from_numpy(
        (rng.standard_normal(s) * c).astype(np.float32)).bfloat16()
        for s, c in zip(shapes, scales))


def _round_bf16(x):
    return x.bfloat16().double()


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (64, 96, True, None), (80, 80, True, 32), (48, 100, False, 40)])
def test_bf16_rounding_of_p_and_ds_stays_inside_bound(hq, hkv, dh, sq, sk,
                                                      causal, window):
    """o, dq, dv and dk from the plain formulas with P (and dS) rounded to
    bf16 before their products, against the same with fp32 P and dS, all
    in float64: every difference is inside ``sm90_rounding_bound``."""
    q, k, v, do = _bf16_inputs(hq * 100 + dh + sq, 2, hq, hkv, sq, sk, dh)
    kw = dict(causal=causal, window=window)
    o, lse = fl.flash_attention_fwd_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    b_o, b_dq, b_dk, b_dv = fl.sm90_rounding_bound(q, k, v, do, lse, delta,
                                                   **kw)

    scale, q_offset, kv_len = fl._resolve(q, k, None, None, None)
    rep = hq // hkv
    mask = fl._mask(sq, sk, q_offset, kv_len, causal, window, "cpu")
    p = fl._probs(q, k, lse, mask, scale)               # fp32, as the kernels
    vx, kx = (fl._expand(x, rep).double() for x in (v, k))
    dp = torch.einsum("bhsd,bhtd->bhst", do.double(), vx).float()
    ds = p * (dp - delta[..., None])                   # fp32, as the kernels

    def group_sum(x):
        return x.reshape(2, hkv, rep, sk, dh).sum(dim=2)

    o_exact = torch.einsum("bhst,bhtd->bhsd", p.double(), vx)
    o_round = torch.einsum("bhst,bhtd->bhsd", _round_bf16(p), vx)
    dv_exact = group_sum(torch.einsum("bhst,bhsd->bhtd", p.double(),
                                      do.double()))
    dv_round = group_sum(torch.einsum("bhst,bhsd->bhtd", _round_bf16(p),
                                      do.double()))
    dq_exact = torch.einsum("bhst,bhtd->bhsd", ds.double(), kx) * scale
    dq_round = torch.einsum("bhst,bhtd->bhsd", _round_bf16(ds), kx) * scale
    dk_exact = group_sum(torch.einsum("bhst,bhsd->bhtd", ds.double(),
                                      q.double())) * scale
    dk_round = group_sum(torch.einsum("bhst,bhsd->bhtd", _round_bf16(ds),
                                      q.double())) * scale
    assert float(p.max()) > 0 and float(ds.abs().max()) > 0
    for name, exact, rounded, bound in (
            ("o", o_exact, o_round, b_o), ("dq", dq_exact, dq_round, b_dq),
            ("dv", dv_exact, dv_round, b_dv),
            ("dk", dk_exact, dk_round, b_dk)):
        diff = (rounded - exact).abs()
        assert bool((diff <= bound.double()).all()), \
            f"{name}: rounding moved {float(diff.max())} past its bound"
        # the bound is not vacuous: rounding does move the result
        assert float(diff.max()) > 0, name
