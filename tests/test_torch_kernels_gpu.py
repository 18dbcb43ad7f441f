"""The port's CUDA kernels against their plain PyTorch versions over a
sweep of shapes. Needs a CUDA card: marked ``gpu`` and skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: o at the reference's kernel tolerances (3e-4 fp32, 4e-2 bf16,
``tests/test_kernels.py:14``); states in fp32 at 1e-4 (both sides sum in
fp32, in chunks of 64 against blocks of up to 128); log decay at 1e-5.
"""

import pytest
import torch

from repro_torch.core.linear_attention import RESET_LOG_A, pick_block
from repro_torch.kernels.lasp2_chunk import (lasp2_chunk_fwd,
                                             lasp2_chunk_fwd_plain)
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


@pytest.mark.parametrize("s", [1, 37, 64, 200, 512])
@pytest.mark.parametrize("dk,dv", [(16, 64), (64, 64), (128, 128),
                                   (32, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_kernel_matches_plain(gen, s, dk, dv, dtype):
    bh = 6
    q = (torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3)
    k = (torch.randn(bh, s, dk, generator=gen, device="cuda") * 0.3)
    v = (torch.randn(bh, s, dv, generator=gen, device="cuda") * 0.5)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    la = -torch.rand(bh, s, generator=gen, device="cuda") * 0.05
    la[:, s // 3] = RESET_LOG_A
    o, st, ld = lasp2_chunk_fwd(q, k, v, la)
    torch.cuda.synchronize()
    o_p, st_p, ld_p = lasp2_chunk_fwd_plain(q, k, v, la,
                                            block_size=pick_block(s, 128))
    assert o.dtype == dtype and st.dtype == torch.float32
    _close(o, o_p, TOL[dtype])
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)


@pytest.mark.parametrize("dk,dv", [(16, 16), (64, 128), (128, 64),
                                   (128, 128), (32, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_in_place(gen, dk, dv, dtype):
    bh = 10
    st0 = torch.randn(bh, dk, dv, generator=gen, device="cuda")
    ld0 = -torch.rand(bh, generator=gen, device="cuda")
    st, ld = st0.clone(), ld0.clone()
    st_p, ld_p = st0.clone(), ld0.clone()
    for _ in range(4):
        q, k = (torch.randn(bh, dk, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        v = torch.randn(bh, dv, generator=gen, device="cuda").to(dtype)
        la = -torch.rand(bh, generator=gen, device="cuda") * 0.1
        o, st_out, ld_out = lasp2_decode_step(q, k, v, la, st, ld)
        assert st_out.data_ptr() == st.data_ptr()      # updated in place
        o_p, st_p, ld_p = lasp2_decode_step_plain(q, k, v, la, st_p, ld_p)
        _close(o, o_p, TOL[torch.float32])
    torch.cuda.synchronize()
    _close(st, st_p, 1e-4)
    _close(ld, ld_p, 1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = torch.zeros(2, 8, 24, device="cuda")           # dk % 16 != 0
    la = torch.zeros(2, 8, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        lasp2_chunk_fwd(q, q, q[..., :16].repeat(1, 1, 4), la)
    x = torch.zeros(2, 16, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        lasp2_chunk_fwd(x.transpose(1, 2), x.transpose(1, 2),
                        torch.zeros(2, 8, 64, device="cuda"), la)
    with pytest.raises(TypeError, match="float32"):
        lasp2_chunk_fwd(q[..., :16], q[..., :16],
                        torch.zeros(2, 8, 64, device="cuda"), la.half())
