"""Named sequence-parallel collectives with call-time communication
accounting (twin of ``repro/comm/primitives.py``).

Each primitive issues exactly one collective on a ``torch.distributed``
process group and appends a :class:`CommRecord` to the ambient tape
(:func:`tape`): the op, the payload entering the collective, the
per-rank wire traffic under the ring cost model the reference uses, the
number of sequential exchange steps and the call-site tag. The reference
records at trace time; here records are taken when the primitive is
called, so a tape around one train step holds that step's collectives
(the backward ones included: autograd calls the primitives' backward
collectives, which record themselves).

    with comm.tape() as records:
        step(state, batch)
    bytes_on_wire = sum(r.traffic_bytes for r in records)

Beside the tape, the **issued** view (:func:`issued`) counts what reaches
``torch.distributed`` itself: while it is open, the data-moving entry
points of the module (``all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``, ``batch_isend_irecv``
and the list forms, ``broadcast``, ``reduce``, ``send``, ``recv``) are
wrapped, and each call is counted with its op, the bytes this rank hands
over and the tag of the primitive that recorded it last ("" for a call
no primitive recorded). So a collective that bypasses the primitives, or
a primitive whose record and call disagree, shows as drift when the
flight recorder (``obs/flight_recorder.py``) compares the two views.
Both are host-side bookkeeping and add no device work.

Transport. An NCCL group takes device tensors as they are. gloo is a host
transport: on a gloo group every primitive copies its operand to host
memory and its result back to the operand's device itself (a no-op for
CPU tensors). The rule follows the group's backend; it does not wait for
an error. The host copies of device tensors are pinned (a non-blocking
device-to-host copy, waited for before the transport reads it), so both
directions run at the link's rate rather than pageable memory's. Two
ranks that share one card cannot use NCCL (it refuses two ranks on one
device), so they run gloo through the host.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.analysis.decorators import host_sync_allowed

# Wire-dtype registry of the ``comm_dtype`` knob: exchanges cast their
# payload to this dtype before the collective and combine in fp32 locally;
# "bf16" halves every state/KV exchange's bytes.
_COMM_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}


def wire_dtype(comm_dtype: Optional[str]) -> torch.dtype:
    """Resolve a ``comm_dtype`` knob value ("fp32" | "bf16") to a dtype."""
    if comm_dtype is None:
        return torch.float32
    try:
        return _COMM_DTYPES[comm_dtype]
    except KeyError:
        raise ValueError(
            f"unknown comm_dtype {comm_dtype!r}; expected one of "
            f"{tuple(_COMM_DTYPES)}") from None


def upcast_gathered(x, dtype=torch.float32):
    """Upcast a gathered wire-dtype payload to the local accumulate dtype.
    The reference pins the cast behind an optimization barrier so XLA
    cannot move it across the collective; eager PyTorch moves nothing, so
    this is a plain cast (a no-op when no cast is needed)."""
    return x if x.dtype == dtype else x.to(dtype)


@dataclass(frozen=True)
class CommRecord:
    """One collective issued by an SP layer or the train step."""

    op: str              # all-gather | reduce-scatter | all-reduce |
    #                      all-to-all | collective-permute
    payload_bytes: int   # bytes entering the collective, per rank
    traffic_bytes: int   # per-rank wire traffic (ring cost model)
    steps: int           # sequential exchange steps this call represents
    group: int           # ranks participating
    tag: str = ""        # call-site label, e.g. "lasp2.states"
    dtype: str = ""      # the payload's dtype on the wire, e.g. "bfloat16"
    shape: tuple = ()    # the payload's shape entering the collective


# The tape is process-wide, not per thread: autograd runs the backward of
# CUDA tensors on its own device thread, and those collectives belong on
# the tape of the step that caused them.
_LOCK = threading.Lock()
_TAPES: List[List[CommRecord]] = []


@contextmanager
def tape():
    """Collect the CommRecords of every primitive called inside the
    block (nested tapes each see the records made while they are open)."""
    records: List[CommRecord] = []
    with _LOCK:
        _TAPES.append(records)
    try:
        yield records
    finally:
        with _LOCK:
            _TAPES.remove(records)


_LAST_TAG = [""]      # the tag of the newest record, for the issued view


def _record(rec: CommRecord) -> None:
    with _LOCK:
        _LAST_TAG[0] = rec.tag
        for records in _TAPES:
            records.append(rec)


@dataclass(frozen=True)
class IssuedRecord:
    """One call into ``torch.distributed``, as this rank issued it."""

    op: str              # the tape's op names
    nbytes: int          # bytes this rank handed to the transport
    tag: str = ""        # the tag of the primitive that recorded it


def _sent(*tensors) -> int:
    return sum(_nbytes(t) for t in tensors)


def _p2p_sent(ops) -> int:
    return sum(_nbytes(o.tensor) for o in ops if o.op is dist.isend)


# entry point of torch.distributed -> (the tape's op name, the argument it
# sends and that argument's keyword, bytes of that argument)
_ENTRY_POINTS = {
    "all_reduce": ("all-reduce", 0, "tensor", _sent),
    "all_gather_into_tensor": ("all-gather", 1, "input_tensor", _sent),
    "all_gather": ("all-gather", 1, "tensor", _sent),
    "reduce_scatter_tensor": ("reduce-scatter", 1, "input", _sent),
    "reduce_scatter": ("reduce-scatter", 1, "input_list",
                       lambda ts: _sent(*ts)),
    "all_to_all_single": ("all-to-all", 1, "input", _sent),
    "all_to_all": ("all-to-all", 1, "input_tensor_list",
                   lambda ts: _sent(*ts)),
    "batch_isend_irecv": ("collective-permute", 0, "p2p_op_list", _p2p_sent),
    "broadcast": ("broadcast", 0, "tensor", _sent),
    "reduce": ("reduce", 0, "tensor", _sent),
    "send": ("send", 0, "tensor", _sent),
    "recv": ("recv", 0, "tensor", lambda t: 0),
}
_ISSUED: List[List[IssuedRecord]] = []
_ORIGINALS: Dict[str, object] = {}


def _counted(name, fn):
    op, pos, key, nbytes = _ENTRY_POINTS[name]

    def call(*args, **kwargs):
        arg = args[pos] if len(args) > pos else kwargs[key]
        with _LOCK:
            rec = IssuedRecord(op, nbytes(arg), _LAST_TAG[0])
            _LAST_TAG[0] = ""
            for records in _ISSUED:
                records.append(rec)
        return fn(*args, **kwargs)
    return call


@contextmanager
def issued():
    """Collect an :class:`IssuedRecord` for every call into
    ``torch.distributed``'s data-moving entry points made inside the
    block, by anyone (shaped like :func:`tape`; the entry points are
    wrapped while at least one such block is open)."""
    records: List[IssuedRecord] = []
    with _LOCK:
        _LAST_TAG[0] = ""
        if not _ISSUED:
            for name in _ENTRY_POINTS:
                _ORIGINALS[name] = getattr(dist, name)
                setattr(dist, name, _counted(name, _ORIGINALS[name]))
        _ISSUED.append(records)
    try:
        yield records
    finally:
        with _LOCK:
            _ISSUED.remove(records)
            if not _ISSUED:
                for name, fn in _ORIGINALS.items():
                    setattr(dist, name, fn)
                _ORIGINALS.clear()


def tape_summary(records: List[CommRecord]) -> Dict[str, float]:
    """Totals per op and overall (the reference's summary keys)."""
    out: Dict[str, float] = {}
    for r in records:
        out[r.op] = out.get(r.op, 0) + r.traffic_bytes
        out[f"{r.op}_count"] = out.get(f"{r.op}_count", 0) + 1
        out[f"{r.op}_steps"] = out.get(f"{r.op}_steps", 0) + r.steps
    out["total_bytes"] = sum(r.traffic_bytes for r in records)
    out["total_steps"] = sum(r.steps for r in records)
    return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _wire(x) -> dict:
    """A record's ``dtype`` and ``shape`` fields for payload ``x``."""
    return {"dtype": str(x.dtype).split(".")[-1], "shape": tuple(x.shape)}


def group_index(group) -> int:
    """This rank's index in ``group``: its sequence chunk ``t`` on an SP
    group, its shard on a data group (the counterpart of the reference's
    ``multi_axis_index``; groups list their ranks in global order, data
    index major, so the index is the gathered position of this rank's
    slice)."""
    return dist.get_rank(group)


# ---------------------------------------------------------------------------
# Transport: host staging on gloo groups, and a pending collective.
# ---------------------------------------------------------------------------

def _staged(group) -> bool:
    """True where the group's transport is the host (gloo)."""
    return dist.get_backend(group) == dist.Backend.GLOO


@host_sync_allowed
def _to_host(x):
    """``x`` in host memory for a gloo collective: a CPU tensor as it is;
    a device tensor copied without blocking (PyTorch pins the destination
    of a non-blocking device-to-host copy), the copy waited for. gloo
    reads host memory only, so this wait is the transport's own: the one
    deliberate host sync of the collectives."""
    if x.device.type == "cpu":
        return x
    host = x.to("cpu", non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


class Pending:
    """A collective in flight: ``wait()`` waits for its ``works`` and
    returns its result, passed through ``finish``."""

    def __init__(self, works, out, finish):
        self._works, self._out, self._finish = works, out, finish

    def then(self, fn) -> "Pending":
        """The same collective, its result passed on through ``fn``."""
        return Pending(self._works, self._out,
                       lambda out: fn(self._finish(out)))

    def wait(self):
        for work in self._works:
            work.wait()
        return self._finish(self._out)


def _start(op, out_shape, x, group, async_op) -> Pending:
    """Issue ``op(out, x, group=, async_op=)`` into a new ``out`` of
    ``out_shape``, staged through host memory on gloo. The result comes
    back on ``x``'s device."""
    device = x.device
    if _staged(group):
        x = _to_host(x)
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device,
                      pin_memory=x.device != device)     # staged: pinned
    work = op(out, x.contiguous(), group=group, async_op=async_op)
    return Pending([work] if async_op else [], out, lambda o: o.to(device))


def _gather(x, group, gather_axis, tiled, async_op) -> Pending:
    w = dist.get_world_size(group)
    src = x.movedim(gather_axis, 0) if tiled else x
    pend = _start(dist.all_gather_into_tensor,
                  (w * src.shape[0], *src.shape[1:]), src, group, async_op)
    if tiled:
        return pend.then(lambda out: out.movedim(0, gather_axis))
    return pend.then(lambda out: out.view(w, *x.shape))


def _scatter(ct, group, scatter_axis, tiled):
    """This rank's slice of the gathered layout of :func:`_gather`, summed
    over the ranks' ``ct``."""
    w = dist.get_world_size(group)
    src = ct.movedim(scatter_axis, 0) if tiled else ct.flatten(0, 1)
    out = _start(dist.reduce_scatter_tensor,
                 (src.shape[0] // w, *src.shape[1:]), src, group,
                 False).wait()
    return out.movedim(0, scatter_axis) if tiled else out


# ---------------------------------------------------------------------------
# The collectives.
# ---------------------------------------------------------------------------

class _AttachGather(torch.autograd.Function):
    """Identity on the gathered tensor whose backward is the AD transpose
    of the all-gather: a reduce-scatter that sums over ranks the
    cotangents of this rank's slice. ``torch.distributed.nn``'s gather is
    not used: on backends other than NCCL its backward is an all-to-all
    emulation, and the tape would then record the wrong collective."""

    @staticmethod
    def forward(ctx, x, gathered, group, gather_axis, tiled, tag):
        ctx.group, ctx.axis, ctx.tiled, ctx.tag = group, gather_axis, \
            tiled, tag
        return gathered

    @staticmethod
    def backward(ctx, ct):
        return (reduce_scatter_grads(ct, ctx.group, scatter_axis=ctx.axis,
                                     tiled=ctx.tiled, tag=f"{ctx.tag}.bwd"),
                None, None, None, None, None)


def allgather_states(x, group, *, gather_axis: int = 0, tiled: bool = False,
                     tag: str = "", async_op: bool = False):
    """AllGather over ``group`` — THE LASP-2 exchange.

    ``tiled=False`` stacks the ranks' tensors on a new leading axis (W,
    ...); ``tiled=True`` concatenates them along ``gather_axis`` in rank
    order. Differentiable: the backward is the reduce-scatter (recorded
    with tag ``<tag>.bwd``). Traffic per rank (ring model): ``(g-1) ×
    payload``; one call is one sequential step whatever the group size.
    ``async_op=True`` returns a :class:`Pending` (issued, not waited on);
    otherwise the gathered tensor.
    """
    w = dist.get_world_size(group)
    pb = _nbytes(x)
    _record(CommRecord("all-gather", pb, (w - 1) * pb, steps=1, group=w,
                       tag=tag, **_wire(x)))
    pend = _gather(x.detach(), group, gather_axis, tiled, async_op).then(
        lambda out: _AttachGather.apply(x, out, group, gather_axis, tiled,
                                        tag))
    return pend if async_op else pend.wait()


def reduce_scatter_grads(x, group, *, scatter_axis: int = 0,
                         tiled: bool = True, tag: str = ""):
    """Reduce-scatter over ``group`` — the AD transpose of the state
    AllGather. ``tiled=True`` splits ``scatter_axis`` into the ranks'
    slices; ``tiled=False`` takes a leading axis of size W. Traffic per
    rank: ``(g-1)/g × payload``."""
    w = dist.get_world_size(group)
    pb = _nbytes(x)
    _record(CommRecord("reduce-scatter", pb, (w - 1) * pb // w, steps=1,
                       group=w, tag=tag, **_wire(x)))
    return _scatter(x, group, scatter_axis, tiled)


def psum_packed(x, group, *, tag: str = ""):
    """All-reduce (sum) ``x`` over ``group`` in ONE collective, in place —
    the DP×SP step's single gradient reduction (every gradient plus the
    loss and token counters in one fp32 vector, ``repro_torch.train``).
    Traffic per rank (ring model): ``2(g-1)/g × payload``. Returns ``x``.
    """
    w = dist.get_world_size(group)
    pb = _nbytes(x)
    _record(CommRecord("all-reduce", pb, 2 * (w - 1) * pb // max(w, 1),
                       steps=1, group=w, tag=tag, **_wire(x)))
    if _staged(group) and x.device.type != "cpu":
        host = _to_host(x)
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def allreduce_sum(x, group, *, tag: str = ""):
    """The sum of ``x`` over ``group``'s ranks, in one all-reduce: a
    serving plan's partial activations (the row-parallel products under
    tensor parallelism, which arrive in fp32; the vocab-parallel lookup).
    The sum runs in fp32 whatever ``x``'s dtype (the record carries fp32)
    and comes back in ``x``'s dtype. Not differentiable: serving runs no backward. Traffic
    per rank (ring model): ``2(g-1)/g × payload``."""
    w = dist.get_world_size(group)
    buf = x.detach().float()
    pb = _nbytes(buf)
    _record(CommRecord("all-reduce", pb, 2 * (w - 1) * pb // max(w, 1),
                       steps=1, group=w, tag=tag, **_wire(buf)))
    if _staged(group) and buf.device.type != "cpu":
        host = _to_host(buf)
        dist.all_reduce(host, group=group)
        buf.copy_(host)
    else:
        dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def _hop(x, group, shift, tag) -> Pending:
    """Issue one cyclic hop of ``x`` (recorded under ``tag``)."""
    w = dist.get_world_size(group)
    pb = _nbytes(x)
    _record(CommRecord("collective-permute", pb, pb, steps=1, group=w,
                       tag=tag, **_wire(x)))
    t = group_index(group)
    device = x.device
    src = (_to_host(x) if _staged(group) else x).contiguous()
    out = torch.empty_like(src)
    peer = lambda i: dist.get_global_rank(group, i % w)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, peer(t + shift), group),
        dist.P2POp(dist.irecv, out, peer(t - shift), group)])
    return Pending(works, out, lambda o: o.to(device))


class _AttachHop(torch.autograd.Function):
    """Identity on the received tensor whose backward is the hop the
    other way round, from the sender's cotangent."""

    @staticmethod
    def forward(ctx, x, received, group, shift, tag):
        ctx.group, ctx.shift, ctx.tag = group, shift, tag
        return received

    @staticmethod
    def backward(ctx, ct):
        return (_hop(ct, ctx.group, -ctx.shift, f"{ctx.tag}.bwd").wait(),
                None, None, None, None)


def ring_sendrecv(x, group, *, shift: int = 1, tag: str = "",
                  async_op: bool = False):
    """One ring hop: every rank sends ``x`` to ``(t + shift) % W`` and
    returns what ``(t - shift) % W`` sent. Differentiable: the backward is
    the hop with ``-shift`` (tag ``<tag>.bwd``). Traffic per rank: the
    payload, one step. ``async_op=True`` returns a :class:`Pending`.
    Every rank must run every hop, backward included, in the same order:
    a rank that skipped one would leave its peers waiting."""
    pend = _hop(x.detach(), group, shift, tag).then(
        lambda out: _AttachHop.apply(x, out, group, shift, tag))
    return pend if async_op else pend.wait()


def _a2a(x, group, split_axis, concat_axis, tag):
    w = dist.get_world_size(group)
    pb = _nbytes(x)
    _record(CommRecord("all-to-all", pb, (w - 1) * pb // max(w, 1), steps=1,
                       group=w, tag=tag, **_wire(x)))
    device = x.device
    # all_to_all_single splits dim 0: block j of the split axis to rank j
    src = x.movedim(split_axis, 0)
    src = src.reshape(w, src.shape[0] // w, *src.shape[1:])
    if _staged(group):
        src = _to_host(src)
    src = src.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    # out[j] is rank j's block; concatenate along concat_axis in rank order
    out = out.to(device).movedim(1, split_axis + 1).movedim(0, concat_axis)
    return out.flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all whose backward is the mirrored all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, tag):
        ctx.args = (group, split_axis, concat_axis, tag)
        return _a2a(x, group, split_axis, concat_axis, tag)

    @staticmethod
    def backward(ctx, ct):
        group, split_axis, concat_axis, tag = ctx.args
        return (_a2a(ct, group, concat_axis, split_axis, f"{tag}.bwd"),
                None, None, None, None)


def alltoall(x, group, *, split_axis: int, concat_axis: int, tag: str = ""):
    """Tiled All-to-All over ``group``: the Ulysses repartition.

    Splits ``split_axis`` into W blocks (block j to rank j) and
    concatenates the received blocks along ``concat_axis`` in rank order:
    ``dim[split] /= W``, ``dim[concat] *= W``. Differentiable: the
    backward is the all-to-all with the axes swapped (tag ``<tag>.bwd``).
    Traffic per rank: ``(g-1)/g × payload``, one step."""
    return _AllToAll.apply(x, group, split_axis, concat_axis, tag)


# ---------------------------------------------------------------------------
# Ring and pipelined prefix-scan exchanges (LASP-1's pattern, ZeCO's
# refinement).
# ---------------------------------------------------------------------------

def auto_slices(dv: int, preferred: int = 4) -> int:
    """Slice count of the pipelined exchange: the largest power of two
    <= ``preferred`` that divides the state's value dimension."""
    n = preferred
    while n > 1 and dv % n:
        n //= 2
    return max(n, 1)


def pipelined_prefix_exchange(m_loc, log_decay, group, *,
                              n_slices: Optional[int] = None,
                              wire: torch.dtype = torch.float32,
                              tag: str = "pipelined",
                              async_op: bool = False):
    """ZeCO-style pipelined ring prefix-scan of the chunk states.

    ``m_loc``: (..., dk, dv) fp32 local chunk state; ``log_decay``: (...,)
    fp32 total chunk log decay. Returns the decayed prefix state
    ``M_{1:t-1}`` (what ``prefix_state_combine`` makes of a full gather).
    The combine is linear in the state, so the state splits along ``dv``
    into ``n_slices`` independent ring chains (tags ``<tag>[i]``); the
    volume is the plain ring's. ``n_slices=1`` is LASP-1's ring (tag
    ``tag``); None picks :func:`auto_slices`.

    Each chain makes W-1 hops. At hop s, rank t receives the packet that
    rank ``t-1-s`` started, with every forwarding rank's chunk decay
    already folded in, and adds it when ``t-1-s >= 0``. The condition is
    a 0/1 factor, not a branch, so every rank's autograd graph holds
    every hop in the same order and the backward hops pair up across
    ranks. A chain waits only for its own hop before it forwards the
    packet, so one slice's hop is in flight while another's is added and
    sent on. ``wire``: each hop's payload dtype (a bf16 wire rounds the
    packet again at every hop); the sums stay fp32.

    ``async_op=True`` issues every chain's first hop and returns a
    :class:`Pending` whose ``wait()`` runs the rest.
    """
    dv = m_loc.shape[-1]
    if n_slices is None:
        n_slices = auto_slices(dv)
    if dv % n_slices:
        raise ValueError(f"n_slices={n_slices} does not divide dv={dv}")
    w, t = dist.get_world_size(group), group_index(group)
    chunk_decay = torch.exp(log_decay)[..., None, None]
    slices = torch.chunk(m_loc, n_slices, dim=-1)
    tags = [tag] if n_slices == 1 else \
        [f"{tag}[{i}]" for i in range(n_slices)]
    send = lambda i, packet: ring_sendrecv(packet.to(wire), group,
                                           tag=tags[i], async_op=True)
    hops = [send(i, m) for i, m in enumerate(slices)] if w > 1 else []

    def finish(_):
        m_prev = [torch.zeros_like(m) for m in slices]
        for s in range(w - 1):
            for i in range(n_slices):
                packet = upcast_gathered(hops[i].wait())
                m_prev[i] = m_prev[i] + packet * float(t - 1 - s >= 0)
                if s < w - 2:
                    hops[i] = send(i, packet * chunk_decay)
        return torch.cat(m_prev, dim=-1) if n_slices > 1 else m_prev[0]

    pend = Pending([], None, finish)
    return pend if async_op else pend.wait()
