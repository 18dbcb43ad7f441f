"""Port vs reference: the sharding plans (``repro_torch.sharding.rules``).

The reference's ``make_plan``, ``fit_spec`` and ``param_specs`` read a
mesh's ``axis_names`` and ``shape`` only, so they run here on a stand-in
mesh of any size (the production 16×16 and 2×16×16 included) with no
devices. Its axis names come from ``repro.launch.mesh`` and map to the
port's ``Axis`` members (``AXES``); nothing here spells them. Plans must
agree rule for rule: the logical rules, the SP axes, the decode cache
axis, the ZeRO-1 axis, the manual axes, the FSDP, TP and DP axes, for
every id of ``ALL_IDS`` and every kind; ``param_specs`` leaf by leaf
through the weight-carrying map (``models/weights.py``: layer ``g·P + p``
is group ``g`` of pattern position ``p``, whose stacked group dim the
reference's spec leads with); and both refuse the same plans.
"""

import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.comm.spec import CommSpec as JCommSpec
from repro.configs import get_config as j_get_config
from repro.launch.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS, SEQ_AXIS
from repro.models import model as JM
from repro.sharding import rules as J
from repro_torch.comm.spec import CommSpec
from repro_torch.configs import ALL_IDS, get_config
from repro_torch.launch.mesh import Axis, Layout, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.sharding import rules as T

AXES = {DATA_AXIS: Axis.DATA, MODEL_AXIS: Axis.MODEL, POD_AXIS: Axis.POD,
        SEQ_AXIS: Axis.SEQUENCE}
D, M, PD, S = DATA_AXIS, MODEL_AXIS, POD_AXIS, SEQ_AXIS

LAYOUTS = {"16x16": ((D, M), (16, 16)), "2x16x16": ((PD, D, M), (2, 16, 16)),
           "4x2": ((D, M), (4, 2)), "dp2sp4": ((D, S), (2, 4)),
           "dp2sp2tp2": ((D, S, M), (2, 2, 2)),
           "dp1sp2tp2": ((D, S, M), (1, 2, 2))}


def _mesh(name):
    axes, sizes = LAYOUTS[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes,
                                                                 sizes)))


def _layout(name):
    axes, sizes = LAYOUTS[name]
    return Layout(tuple(AXES[a] for a in axes), sizes)


def _ax(v):
    """A reference rule value in the port's terms."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(_ax(a) for a in v)
    return AXES[v]


def _spec(p):
    return T.Spec(*(_ax(e) for e in p))


@pytest.mark.parametrize("shape,spec", [
    ((32, 48), (D, M)), ((30, 48), (D, M)), ((32, 40), (D, M)),
    ((64, 7), ((PD, D), None)), ((48, 7), ((PD, D), None)),
    ((6, 7), ((PD, D), None)), ((2, 7), ((PD, D, M), None)),
    ((32, 32), ((PD, D, M),)), ((4, 8, 2), (None, M)),
    ((512,), ((D, M),))])
def test_fit_spec_matches_reference(shape, spec):
    """Entries whose axis size does not divide the dim drop; a compound
    entry keeps its longest dividing prefix (on 2×16×16)."""
    want = J.fit_spec(_mesh("2x16x16"), shape, P(*spec))
    got = T.fit_spec(_layout("2x16x16"), shape, T.Spec(*(_ax(e)
                                                         for e in spec)))
    assert got == _spec(want)


def _check_plan(got, want, layout):
    assert {k: _ax(v) for k, v in want.rules.items()} == got.rules
    sp_axes = () if want.sp is None else tuple(
        _ax(a) for a in want.sp.exchange_axes)
    assert got.sp_axes == sp_axes
    degree = 1 if want.sp is None else int(np.prod(
        [layout.axis_size(AXES[a]) for a in want.sp.exchange_axes]))
    assert got.sp_degree == degree
    assert got.sp_manual == bool(want.sp is not None and want.sp.manual)
    assert got.decode_cache_axis == _ax(want.decode_cache_axis)
    assert got.zero1_axis == _ax(want.zero1_axis)
    assert got.manual_axes == _ax(tuple(want.manual_axes))
    assert got.fsdp_axis == _ax(want.fsdp_axis)
    assert got.tp_axis == _ax(want.tp_axis)
    assert got.dp_axes == _ax(tuple(want.dp_axes))
    assert got.sp is None          # a layout without ranks


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_plan_matches_reference(layout, kind):
    """Every ``ALL_IDS`` config's plan at each layout and kind, at the
    batch that divides (32) and one that does not (1, the train SP
    fallback), with the params small and large (the hymba / whisper
    prefill branch that puts the batch over model needs both heads that
    do not divide and weights under 6 GiB)."""
    mesh, lay = _mesh(layout), _layout(layout)
    for arch in ALL_IDS:
        cfg = get_config(arch)
        for batch in (32, 1):
            for pbytes in (cfg.param_count() * 2, 2 ** 30):
                kw = dict(global_batch=batch, n_kv_heads=cfg.n_kv_heads,
                          n_heads=cfg.n_heads, params_bytes=pbytes)
                try:
                    want = J.make_plan(mesh, kind,
                                       comm=JCommSpec("allgather"), **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        T.make_plan(lay, kind, **kw)
                    continue
                _check_plan(T.make_plan(lay, kind, **kw), want, lay)


def test_prefill_batch_over_model_branch_is_taken():
    """hymba-1.5b's 25 heads do not divide 16: its prefill plan at 16×16
    puts the batch over model and replicates weights on it, in both."""
    cfg = get_config("hymba-1.5b")
    kw = dict(global_batch=32, n_kv_heads=cfg.n_kv_heads,
              n_heads=cfg.n_heads, params_bytes=cfg.param_count() * 2)
    got = T.make_plan(make_production_mesh(), "prefill", **kw)
    assert got.rules["batch"] == Axis.MODEL and got.tp_axis is None
    assert got.rules["heads"] is None and got.sp_axes == (Axis.DATA,)


@pytest.mark.parametrize("strategy,heads", [
    ("ring", (8, 8)), ("pipelined", (8, 8)), ("ulysses", (6, 3)),
    ("ulysses", (8, 8))])
def test_train_plan_refusals_match_reference(strategy, heads):
    """The 3D train plan refuses ring and pipelined, and Ulysses when the
    heads do not divide the model axis: in both packages alike."""
    hq, hkv = heads
    kw = dict(global_batch=8, n_heads=hq, n_kv_heads=hkv)
    try:
        J.make_plan(_mesh("dp2sp2tp2"), "train",
                    comm=JCommSpec(strategy), **kw)
        refused = False
    except ValueError:
        refused = True
    if refused:
        with pytest.raises(ValueError):
            T.make_plan(_layout("dp2sp2tp2"), "train",
                        comm=CommSpec(strategy), **kw)
    else:
        T.make_plan(_layout("dp2sp2tp2"), "train", comm=CommSpec(strategy),
                    **kw)
    assert refused == (strategy != "ulysses" or hq % 2 or hkv % 2)


def test_unknown_kind_refused_in_both():
    with pytest.raises(ValueError):
        J.make_plan(_mesh("16x16"), "serve")
    with pytest.raises(ValueError):
        T.make_plan(_layout("16x16"), "serve")


def test_sp_for_rule():
    """SP only when the length divides the degree; the manual plan's
    length is already a chunk. Checked on plans carrying a stand-in SP
    config (a layout without ranks carries none)."""
    sp = types.SimpleNamespace(degree=4)
    plan = T.make_plan(_layout("4x2"), "prefill", n_kv_heads=2)
    plan.sp = sp
    assert plan.sp_for(64) is sp and plan.sp_for(63) is None
    manual = T.make_plan(_layout("dp1sp2tp2"), "train", n_kv_heads=2)
    manual.sp = sp
    assert manual.sp_for(63) is sp
    assert T.local_plan().sp_for(64) is None
    assert manual.act("x", "batch") == "x"


def _ref_leaves(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    out = {}
    for path, spec in flat:
        out[tuple(str(k.key) if hasattr(k, "key") else str(k.idx)
                  for k in path)] = spec
    return out


def _port_leaves(specs, prefix=()):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_leaves(v, prefix + (k,)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_leaves(v, prefix + (str(i),)))
        return out
    return {prefix: specs}


def _mapped(ref, cfg):
    """The reference's specs keyed by the port's leaf paths: a stacked
    leaf ``groups/p/...`` (its spec led by the group dim) becomes layer
    ``g·P + p``'s, for every group g."""
    out = {}
    for path, spec in ref.items():
        if "groups" not in path:
            out[path] = _spec(spec)
            continue
        i = path.index("groups")
        p, rest = int(path[i + 1]), path[i + 2:]
        n_pat, n_groups = ((len(cfg.pattern), cfg.n_groups)
                           if i == 0 else (1, cfg.encoder.n_layers))
        assert spec[0] is None
        for g in range(n_groups):
            out[path[:i] + ("layers", str(g * n_pat + p)) + rest] = \
                T.Spec(*(_ax(e) for e in tuple(spec)[1:]))
    return out


@pytest.mark.parametrize("arch", ALL_IDS)
def test_param_specs_match_reference(arch):
    """Every leaf's spec under the train, prefill and decode plans of
    16×16 and 2×16×16, on shapes only (``jax.eval_shape``; the port's
    params on ``meta``)."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jshapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    params = TM.init_params(None, cfg, device="meta")
    for layout in ("16x16", "2x16x16"):
        for kind in ("train", "prefill", "decode"):
            kw = dict(global_batch=32, n_kv_heads=cfg.n_kv_heads,
                      n_heads=cfg.n_heads,
                      params_bytes=cfg.param_count() * 2)
            want = _mapped(_ref_leaves(J.param_specs(
                jshapes, J.make_plan(_mesh(layout), kind, **kw))), cfg)
            got = _port_leaves(T.param_specs(
                params, T.make_plan(_layout(layout), kind, **kw)))
            assert got == want, (layout, kind)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@pytest.mark.parametrize("arch", ALL_IDS)
def test_shard_params_bytes_are_the_dry_runs(arch):
    """``shard_params`` on the production 16×16 layout (meta tensors, no
    ranks: the rank named by ``index``): under the prefill and decode
    plans every rank's Σ ``nbytes`` equals ``launch.dryrun._sharded_bytes``
    of the same params and specs, the bytes the dry run reports a rank
    holds, and each leaf's shard is its spec's fraction of it."""
    import torch

    from repro_torch.launch.dryrun import _sharded_bytes
    layout = make_production_mesh()
    cfg = get_config(arch)
    params = TM.init_params(None, cfg, device="meta")
    for kind in ("prefill", "decode"):
        plan = T.make_plan(layout, kind, global_batch=32,
                           n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads,
                           params_bytes=cfg.param_count() * 2)
        specs = T.param_specs(params, plan)
        want = _sharded_bytes(params, specs, layout)
        for d, m in ((0, 0), (15, 15), (3, 12)):
            local = T.shard_params(params, plan,
                                   index={Axis.DATA: d, Axis.MODEL: m})
            got = sum(t.numel() * t.element_size()
                      for _, t in _leaves(local))
            assert got == want, (kind, d, m)
        for path, t in _leaves(local):
            n = 1
            for e in _at(specs, path):
                n *= layout.axis_size(e) if e is not None else 1
            assert t.device == torch.device("meta")
            assert t.numel() * n == _at(params, path).numel(), path


@pytest.mark.parametrize("arch", ALL_IDS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_shard_params_shards_rebuild_every_leaf(arch, kind):
    """SMOKE params on a (2, 2) (data, model) layout: concatenating every
    leaf's shards over the four ranks, along each dim in its spec's axis
    order, rebuilds the leaf exactly; ranks that differ only along an
    axis the leaf's spec does not name hold equal shards."""
    import torch

    from repro_torch.configs import get_smoke
    layout = Layout((Axis.DATA, Axis.MODEL), (2, 2))
    cfg = get_smoke(arch)
    plan = T.make_plan(layout, kind, n_kv_heads=cfg.n_kv_heads)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    specs = T.param_specs(params, plan)
    shards = {(d, m): T.shard_params(params, plan,
                                     index={Axis.DATA: d, Axis.MODEL: m})
              for d in range(2) for m in range(2)}
    split = 0
    for path, whole in _leaves(params):
        spec = _at(specs, path)
        named = [(dim, e) for dim, e in enumerate(spec) if e is not None]
        split += bool(named)

        def cat(fixed, rest):
            if not rest:
                idx = (fixed.get(Axis.DATA, 0), fixed.get(Axis.MODEL, 0))
                return _at(shards[idx], path)
            dim, ax = rest[0]
            return torch.cat([cat({**fixed, ax: i}, rest[1:])
                              for i in range(layout.axis_size(ax))], dim=dim)

        assert torch.equal(cat({}, named), whole), path
        for (d, m), tree in shards.items():
            idx = (d if Axis.DATA in spec else 0,
                   m if Axis.MODEL in spec else 0)
            assert torch.equal(_at(tree, path), _at(shards[idx], path))
    assert split > 0


# (arch, (data, model), first layer of the pattern to read, the
# LayerSplit fields that must hold, the leaves gathered whole over model)
SPLIT_CASES = [
    ("mamba2-2.7b", (1, 4), 0,
     dict(ssd=True, ssd_wo=True, q=False, wo=False), []),
    ("hymba-1.5b", (1, 4), 0,
     dict(ssd=False, ssd_wo=True, q=False, kv=False, wo=True, mlp=True),
     ["mixer.attn.wq", "mixer.attn.wk", "mixer.attn.wv", "mixer.ssm.wx",
      "mixer.ssm.wz", "mixer.ssm.conv_x"]),
    ("hymba-1.5b", (1, 5), 0,
     dict(ssd=True, ssd_wo=True, q=True, kv=True, wo=True, mlp=False), []),
    ("moonshot-v1-16b-a3b", (1, 4), 0,
     dict(q=True, kv=True, wo=True, experts=True, shared=True), []),
    ("moonshot-v1-16b-a3b", (2, 2), 0,
     dict(q=True, kv=True, wo=True, experts=True, shared=True), []),
    ("phi3.5-moe-42b-a6.6b", (1, 32), 0,
     dict(q=False, kv=False, wo=True, experts=False, shared=False),
     ["mixer.wq", "mixer.wk", "mixer.wv"]),
    ("whisper-base", (1, 4), 1,
     dict(q=True, kv=True, wo=True, mlp=True), []),
    ("llama-3.2-vision-90b", (1, 8), 4,
     dict(q=True, kv=True, wo=True, mlp=True), []),
    ("granite-34b", (1, 4), 0,
     dict(q=True, kv=False, wo=True, mlp=True), ["mixer.wk", "mixer.wv"]),
]


@pytest.mark.parametrize("arch,dims,layer,want,whole", SPLIT_CASES)
def test_layer_split_fields_on_meta_params(arch, dims, layer, want, whole):
    """``layer_split`` on ``CONFIG``'s meta params under the decode plan
    of a (data, model) layout without ranks: which pieces compute on the
    rank's shard (attention heads, SSD heads, experts and shared experts,
    the dense ff, the row-parallel ``wo``s), and which leaves the layer
    still gathers whole over model at use (``gathered``: the specs place
    them on model, their piece does not divide: hymba's 25:5 heads and
    25 SSD heads at TP 4, phi3.5's 8 kv heads at TP 32, granite's single
    kv head). A split piece gathers none of its leaves; whisper's
    encoder layers split as its decoder's softmax layers do."""
    cfg = get_config(arch)
    plan = T.make_plan(Layout((Axis.DATA, Axis.MODEL), dims), "decode",
                       n_kv_heads=cfg.n_kv_heads, n_heads=cfg.n_heads)
    params = TM.init_params(None, cfg, device="meta")
    specs = T.param_specs(params, plan)
    spec = cfg.layer_specs()[layer]
    split = T.layer_split(cfg, spec, specs["layers"][layer], plan)
    assert split.size == dims[1] and split.mixer == spec.mixer
    assert {k: getattr(split, k) for k in want} == want

    def gathered(s, tree, specs_, prefix=()):
        if isinstance(tree, dict):
            return [g for k in tree
                    for g in gathered(s, tree[k], specs_[k], prefix + (k,))]
        return [".".join(prefix)] if Axis.MODEL in tuple(specs_) and \
            s.gathered(prefix) else []

    assert gathered(split, params["layers"][layer],
                    specs["layers"][layer]) == whole
    if cfg.encoder is not None:
        enc = T.layer_split(cfg, TM.ENCODER_SPEC,
                            specs["encoder"]["layers"][0], plan)
        assert (enc.q, enc.kv, enc.wo, enc.mlp) == (True,) * 4
        assert gathered(enc, params["encoder"]["layers"][0],
                        specs["encoder"]["layers"][0]) == []
