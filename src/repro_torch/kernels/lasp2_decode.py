"""One-token recurrent linear-attention decode (K3): the Hopper kernels and
their plain PyTorch version.

Twin of ``lasp2_decode_step`` in ``repro/kernels/lasp2_decode.py``. On CUDA
tensors :func:`lasp2_decode_step` launches one of two kernels (design and
bound in each header), on the route :func:`_route` fixes:

* ``sm90``: ``csrc/lasp2_decode_sm90.cu``, which spreads the state over the
  card in 16-column slices, each block's slice issued at once as
  asynchronous copies; for dk a multiple of 16 up to 256 and dv a multiple
  of 4 (every full config);
* ``simt``: ``csrc/lasp2_decode.cu``, the CUDA-core kernel, for every other
  dk that is a multiple of 16.

Both update ``state`` and ``log_decay`` in place. On CPU tensors it runs
the plain version, :func:`lasp2_decode_step_plain` (``recurrent_step``),
which returns new tensors. Callers use the returned tensors either way. A
CUDA tensor that the kernels do not take raises: there is no other path.
"""

from __future__ import annotations

import torch

from repro_torch.core.linear_attention import recurrent_step
from repro_torch.kernels import _build

_DTYPES = (torch.bfloat16, torch.float32)
ROUTES = ("sm90", "simt")
_SM90_MAX_DK = 256
# route -> (source, symbol, pointers, ints) of its C entry
_ENTRIES = {"sm90": ("lasp2_decode_sm90", "lasp2_decode_step_sm90", 7, 4),
            "simt": ("lasp2_decode", "lasp2_decode_step", 7, 4)}


def _route(dtype, dk, dv) -> str:
    """The kernel route of K3 for q/k/v of ``dtype`` with key width ``dk``
    and value width ``dv``, a fixed table: dk a multiple of 16 up to 256
    and dv a multiple of 4 go to ``sm90`` (bf16 and fp32 alike), every
    other shape to ``simt``."""
    return "sm90" if dtype in _DTYPES and dk % 16 == 0 \
        and 16 <= dk <= _SM90_MAX_DK and dv % 4 == 0 else "simt"


def lasp2_decode_step_plain(q, k, v, log_a, state, log_decay):
    """Plain PyTorch version: ``recurrent_step`` (``log_a`` None: no
    decay)."""
    return recurrent_step(q, k, v, log_a, state=state, log_decay=log_decay)


def _check(q, k, v, log_a, state, log_decay):
    dev = q.device
    if k.device != dev or v.device != dev or state.device != dev \
            or log_decay.device != dev \
            or (log_a is not None and log_a.device != dev):
        ts = (q, k, v, state, log_decay) + ((log_a,) if log_a is not None
                                            else ())
        raise ValueError(f"lasp2_decode_step: tensors on several devices "
                         f"{sorted({str(t.device) for t in ts})}")
    qs, vs = q.shape, v.shape
    if len(qs) != 2 or k.shape != qs or len(vs) != 2 or vs[0] != qs[0] \
            or state.shape != (qs[0], qs[1], vs[1]) \
            or log_decay.shape != (qs[0],) \
            or (log_a is not None and log_a.shape != (qs[0],)):
        raise ValueError(
            "lasp2_decode_step: want q, k (BH,dk), v (BH,dv), log_a (BH,) "
            "or None, state (BH,dk,dv), log_decay (BH,); got "
            + ", ".join(str(tuple(t.shape)) for t in
                        (q, k, v, state, log_decay)
                        + ((log_a,) if log_a is not None else ())))


def lasp2_decode_step(q, k, v, log_a, state, log_decay, *, route=None):
    """Batched single-token recurrent decode.

    q, k: (BH, dk); v: (BH, dv) in bf16 or fp32; log_a: (BH,) fp32, or None
    for log a = 0 (no decay: ``log_decay`` unchanged); state: (BH, dk, dv)
    fp32; log_decay: (BH,) fp32.
    Returns (o (BH, dv) fp32, state', log_decay'). On CUDA, ``state'`` and
    ``log_decay'`` are ``state`` and ``log_decay`` themselves, updated in
    place. ``route`` forces one of ``ROUTES`` on the card (tests and
    timings); None takes :func:`_route`'s. ``sm90`` on a shape outside its
    table raises.
    """
    _check(q, k, v, log_a, state, log_decay)
    dev = q.device
    if dev.type == "cpu":
        return lasp2_decode_step_plain(q, k, v, log_a, state, log_decay)
    if dev.type != "cuda":
        raise ValueError(f"lasp2_decode_step: no kernel for {dev}")
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"lasp2_decode_step: q/k/v must share one dtype of "
                        f"{_DTYPES}; got {dtype}, {k.dtype}, {v.dtype}")
    if state.dtype != torch.float32 or log_decay.dtype != torch.float32 \
            or (log_a is not None and log_a.dtype != torch.float32):
        raise TypeError("lasp2_decode_step: log_a, state and log_decay must "
                        "be float32")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and state.is_contiguous() and log_decay.is_contiguous()
            and (log_a is None or log_a.is_contiguous())):
        raise ValueError("lasp2_decode_step: all inputs must be contiguous")
    bh, dk = q.shape
    dv = v.shape[1]
    if bh < 1 or dk < 16 or dk % 16 or dv < 1:
        raise ValueError(f"lasp2_decode_step: kernel takes dk a multiple of "
                         f"16; got dk={dk}, dv={dv}")
    table = _route(dtype, dk, dv)
    if route is None:
        route = table
    elif route not in ROUTES or (route == "sm90" and table != "sm90"):
        raise ValueError(f"lasp2_decode_step: route {route!r} does not take "
                         f"dk={dk}, dv={dv}")
    if route == "sm90" and state.data_ptr() % 16:
        raise ValueError("lasp2_decode_step: the sm90 route needs a 16-byte "
                         "aligned state")
    if log_a is None and route == "simt":
        log_a = torch.zeros((bh,), dtype=torch.float32, device=dev)
    o = torch.empty((bh, dv), dtype=torch.float32, device=dev)
    entry_launch(route, q, k, v, log_a, state, log_decay, o)
    lasp2_decode_step.launches += 1
    lasp2_decode_step.route_launches[route] += 1
    return o, state, log_decay


def entry_launch(route, q, k, v, log_a, state, log_decay, o):
    """Launch K3's C entry on ``route``: ``state`` and ``log_decay`` in
    place, ``o`` written (checked inputs; a ``log_a`` of None is a null
    pointer, which the ``simt`` entry does not take). The wrapper's
    launch, and the guard-band battery's."""
    bh, dk = q.shape
    dv = v.shape[1]
    fn = _build.entry(*_ENTRIES[route])       # typed once, then cached
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if log_a is None else log_a.data_ptr(), state.data_ptr(),
            log_decay.data_ptr(), o.data_ptr(), bh, dk, dv,
            int(q.dtype == torch.bfloat16))
    dev = q.device
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"lasp2_decode_step: kernel launch failed with "
                           f"CUDA error {err}")


# kernel launches (CUDA path only), in all and per route
lasp2_decode_step.launches = 0
lasp2_decode_step.route_launches = dict.fromkeys(ROUTES, 0)
