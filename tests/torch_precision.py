"""How far the port's params and moments may sit from the reference's
after a few bf16-compute AdamW steps from the same state (numpy only: the
one-device test and the DP×SP test's ranks share it).

A trajectory is one dict a step: ``lr`` (the step's learning rate),
``params``, ``m`` and ``v`` (each ``{key: array}`` after the step, keyed
alike in the two packages' trajectories).

* **Moments** (fp32 in both): each leaf's ``m`` and ``v`` within
  ``TOL_MOMENTS`` of the reference's in the 2-norm, after every step.
  The two frameworks round bf16 compute at other points, so an element
  whose gradient nearly cancels may differ by more than its own size;
  a leaf's norm may not.
* **Params**: AdamW moves a param by ``lr·(u + wd·p)`` with
  ``u = m̂ / (√v̂ + eps)`` from the moments just held, and rounds the
  result into the leaf's dtype. So after step T the two packages' params
  differ by at most Σ_t [ulp_t + lr_t·|u_port,t − u_ref,t|]: the
  directions each package's own moments give, plus one rounding a step
  (ulp_t: one ulp of the larger of the two params after step t, in the
  leaf's dtype; 2^-20 of the step's size more for the fp32 arithmetic
  that forms it). A skipped or flipped update moves a param by lr·|u|
  or 2·lr·|u| with moments that agree, and fails.
* **Relaxed share**: where the two packages' first moments straddle 0
  (Adam's first step is sign(g)), the directions differ by up to 2 and
  the bound grows by up to 2·lr. The share of elements whose bound grew
  by more than half the base learning rate stays within
  ``MAX_RELAXED_SHARE``.
"""

import numpy as np

TOL_MOMENTS = 4e-2        # the reference's bf16 limit (tests/test_kernels.py)
MAX_RELAXED_SHARE = 1e-2
B1, B2, EPS = 0.9, 0.95, 1e-8    # RunConfig's adam_b1, adam_b2; AdamW's eps


def ulp(x, dtype: str):
    """One ulp at each element of ``x`` in ``dtype`` ("bfloat16" or
    "float32")."""
    x = np.abs(np.asarray(x, np.float32))
    if dtype == "float32":
        return np.spacing(x).astype(np.float64)
    mag = np.maximum(x, np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float64)


def direction(m, v, count: int):
    """AdamW's bias-corrected direction ``m̂ / (√v̂ + eps)`` in fp64."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - B1 ** count)) / (np.sqrt(v / (1 - B2 ** count)) + EPS)


def mismatches(port, ref, dtypes, base_lr):
    """Every way the port's trajectory breaks the limits above against the
    reference's (``dtypes``: each param key's dtype name); empty when it
    keeps them all."""
    out = []
    bound = {k: 0.0 for k in ref[0]["params"]}
    relaxed = dict(bound)
    for t, (p, r) in enumerate(zip(port, ref, strict=True), start=1):
        lr = r["lr"]
        if not np.isclose(p["lr"], lr, rtol=1e-6, atol=0):
            out.append(f"step {t}: lr {p['lr']} against {lr}")
        for key, want in r["params"].items():
            for name in ("m", "v"):
                a = np.asarray(p[name][key], np.float64)
                b = np.asarray(r[name][key], np.float64)
                off = np.linalg.norm(a - b)
                if off > TOL_MOMENTS * np.linalg.norm(b):
                    out.append(f"step {t} {name} {key}: {off:.4e} off, "
                               f"norm {np.linalg.norm(b):.4e}")
            up = direction(p["m"][key], p["v"][key], t)
            ur = direction(r["m"][key], r["v"][key], t)
            got = np.asarray(p["params"][key], np.float64)
            want = np.asarray(want, np.float64)
            apart = lr * np.abs(up - ur)
            bound[key] = bound[key] + apart + np.maximum(
                ulp(got, dtypes[key]), ulp(want, dtypes[key])) + \
                lr * 2.0 ** -20 * (np.abs(up) + np.abs(ur))
            relaxed[key] = relaxed[key] + apart
            over = np.abs(got - want) > bound[key]
            if over.any():
                worst = float(np.max(np.abs(got - want) - bound[key]))
                out.append(f"step {t} params {key}: {int(over.sum())} of "
                           f"{over.size} past the bound, worst by {worst:.4e}")
    n = sum(np.size(b) for b in bound.values())
    wide = sum(int(np.sum(relaxed[k] > base_lr / 2)) for k in relaxed)
    if wide > MAX_RELAXED_SHARE * n:
        out.append(f"relaxed share {wide} of {n}")
    return out


def reference_keys(paths, flat, n_pattern: int):
    """A flat vector over the port's leaves (``paths`` and their shapes,
    the order of ``leaves_with_paths``) as ``{key: array}`` in the
    reference's layout: each pattern position's layers stacked over a
    leading group axis, keys joined with "/" ("groups/0/mixer/wq")."""
    arrays, off = {}, 0
    for path, shape in paths:
        size = int(np.prod(shape, dtype=np.int64))
        arrays[tuple(path)] = np.asarray(flat[off:off + size]).reshape(shape)
        off += size
    out, stacks = {}, {}
    for path, a in arrays.items():
        if path[0] == "layers":
            key = "/".join(("groups", str(int(path[1]) % n_pattern))
                           + path[2:])
            stacks.setdefault(key, []).append((int(path[1]), a))
        else:
            out["/".join(path)] = a
    for key, layers in stacks.items():
        out[key] = np.stack([a for _, a in sorted(layers, key=lambda x: x[0])])
    return out
