"""Exact GBDT arithmetic in the port (``mmlspark_tpu_torch/gbdt``): the
histograms' int64 fixed point (``cuda_hist.fixed_scale``, K9's plain
version), the objectives' device-identical ``exp``, and what they give:
fits that do not depend on the order of the rows or on how the rows are
spread over a data axis, bit for bit.

* The plain histogram is bitwise invariant under any permutation of the
  rows and equals a Python-integer reference of the fixed-point sums;
  the fixed point cannot overflow at the largest ``|v|`` and up to 2^24
  rows, and its error stays within the bound ``fixed_scale`` states
  (relative to the largest ``|v|``).
* ``objectives.exp`` gives the same bits element by element, as a
  length-1 tensor, inside a long contiguous tensor and inside a strided
  one, within an f32 ulp of ``np.exp`` in f64.
* A 10-class, 15-iteration fit from its rows in two orders: every tree,
  leaf value and prediction equal bit for bit.
* The data and feature learners on a hosted ``{"data": 2}`` and
  ``{"data": 3}`` (rows padded past a power of two), and the data
  learner on two gloo processes, equal the single-device fit bit for
  bit.

These are CPU runs; ``chip_smoke.py`` holds K9 on the card to the plain
version bit for bit and the card's fits to the CPU's.
"""

import json
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu_torch.gbdt import cuda_hist as CH
from mmlspark_tpu_torch.gbdt import objectives as TO
from mmlspark_tpu_torch.parallel import topology as TP

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TREE_FIELDS = ("feature", "threshold", "threshold_bin", "missing_left",
               "categorical", "cat_mask", "left", "right", "value", "gain")


def _inputs(n, f, b, seed, spread=1.0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.int32)
    grad = (rng.normal(size=n) * spread).astype(np.float32)
    hess = rng.uniform(0.0, 1.0, size=n).astype(np.float32) * spread
    mask = rng.uniform(size=n) < 0.7
    return bins, grad, hess, mask


def _plain(bins, grad, hess, mask, f, b, scale, n_bins_layout=None):
    return CH.build_histogram_plain(
        CH.prepare_bins_t(torch.from_numpy(bins), n_bins_layout),
        torch.from_numpy(grad), torch.from_numpy(hess),
        torch.from_numpy(mask), f, b, scale)


# --------------------------------------------------------------------------
# the fixed-point histogram


@pytest.mark.parametrize("n,f,b,layout", [(777, 11, 37, "uint8"),
                                          (5000, 4, 255, "int32"),
                                          (3000, 3, 300, "int32")])
@pytest.mark.parametrize("spread", [1.0, 1e-30, 1e30])
def test_plain_histogram_is_bitwise_invariant_under_row_order(n, f, b,
                                                              layout,
                                                              spread):
    bins, grad, hess, mask = _inputs(n, f, b, seed=n, spread=spread)
    scale = CH.fixed_scale(torch.from_numpy(grad), torch.from_numpy(hess),
                           n)
    lay = b if layout == "uint8" else None
    want = _plain(bins, grad, hess, mask, f, b, scale, lay)
    assert want.dtype == torch.int64 and want.shape == (f, b, 3)
    for seed in range(3):
        p = np.random.default_rng(seed).permutation(n)
        got = _plain(bins[p], grad[p], hess[p], mask[p], f, b, scale, lay)
        assert torch.equal(got, want)
    # the f32 view: the same bits too, and close to the plain f32 sums
    as_f32 = CH.fixed_to_float(want, scale)
    p = np.random.default_rng(9).permutation(n)
    assert torch.equal(CH.fixed_to_float(_plain(
        bins[p], grad[p], hess[p], mask[p], f, b, scale, lay), scale),
        as_f32)
    m = mask.astype(np.float64)
    ref_g = np.zeros((f, b))
    for j in range(f):
        np.add.at(ref_g[j], bins[:, j], grad * m)
    np.testing.assert_allclose(as_f32[..., 0].numpy(), ref_g,
                               rtol=1e-5, atol=1e-5 * spread)


def test_plain_histogram_equals_python_integer_sums():
    """Each value scaled by its channel's power of two and rounded half
    to even (Python's ``round``), summed as Python integers; some values
    lie exactly half way between two grid points."""
    n, f, b = 400, 3, 9
    bins, grad, hess, mask = _inputs(n, f, b, seed=4)
    scale = CH.fixed_scale(torch.from_numpy(grad), torch.from_numpy(hess),
                           n)
    sg, sh = (int(np.log2(float(s))) for s in scale[:2])
    grad[:4] = np.float32([0.5, 1.5, 2.5, -2.5]) * np.float32(2.0 ** -sg)
    mask[:4] = True
    assert torch.equal(CH.fixed_scale(torch.from_numpy(grad),
                                      torch.from_numpy(hess), n), scale)
    assert [round(float(v) * 2.0 ** sg) for v in grad[:4]] == [0, 2, 2, -2]
    got = _plain(bins, grad, hess, mask, f, b, scale).numpy()
    want = np.zeros((f, b, 3), dtype=object)
    want[...] = 0
    for r in range(n):
        if not mask[r]:
            continue
        gi = round(float(grad[r]) * 2.0 ** sg)
        hi = round(float(hess[r]) * 2.0 ** sh)
        for j in range(f):
            want[j, bins[r, j]] += np.array([gi, hi, 1], dtype=object)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1 << 20, (1 << 24) - 1,
                               1 << 24])
@pytest.mark.parametrize("top", [np.float32(1.0), np.float32(0.75),
                                 np.nextafter(np.float32(2.0),
                                              np.float32(0.0)),
                                 np.float32(3e38), np.float32(1e-44),
                                 np.float32(0.0)])
def test_fixed_scale_cannot_overflow(n, top):
    """n rows each at the channel's largest |v|, on the grid
    ``fixed_scale`` picks: the sum stays below 2^62, and one bit more
    would not (the grid uses the headroom)."""
    v = torch.tensor([top, -top], dtype=torch.float32)
    scale = CH.fixed_scale(v, v.abs(), n)
    for c in range(2):
        s = float(scale[c])
        assert s == 2.0 ** round(np.log2(s))          # a power of two
        one = int(CH.to_fixed(torch.tensor([top]), scale[c])[0])
        assert one == round(float(top) * s)
        assert n * abs(one) <= 2 ** CH.FIXED_BITS
        if top > 0:
            assert n * abs(round(float(top) * s * 2)) > 2 ** (
                CH.FIXED_BITS - 1)
    assert float(scale[2]) == 1.0


def test_histogram_of_2_24_rows_at_the_largest_value_is_exact():
    """2^24 rows of the largest |grad| and |hess| in one bin: the
    Python-integer sum, within int64, and back in f32 within an ulp of
    n |v|."""
    n = 1 << 24
    g = torch.full((n,), -1.9999999, dtype=torch.float32)
    h = torch.full((n,), 0.9999999, dtype=torch.float32)
    bins_t = torch.zeros(1, n, dtype=torch.uint8)
    scale = CH.fixed_scale(g, h, n)
    got = CH.build_histogram_plain(bins_t, g, h, torch.ones(
        n, dtype=torch.bool), 1, 2, scale)
    gi = round(float(g[0]) * float(scale[0]))
    hi = round(float(h[0]) * float(scale[1]))
    assert got[0, 0].tolist() == [n * gi, n * hi, n]
    assert max(abs(n * gi), n * hi) <= 2 ** CH.FIXED_BITS
    back = CH.fixed_to_float(got, scale)[0, 0]
    assert float(back[0]) == float(np.float32(n * float(g[0])))
    assert float(back[2]) == n


@pytest.mark.parametrize("log2_n", [10, 20, 24])
def test_fixed_point_error_is_within_its_bound(log2_n):
    """``fixed_scale``'s stated precision: each value moves by at most
    half a grid step, ``max|v| · 2^(ceil(log2 n) - 62)``, so a bin's sum
    of m rows lies within m half steps of the exact sum of its f32
    values (Python fractions). Bin 0 holds only values 2^-29 below the
    largest, whose relative error the bound lets grow with n."""
    rng = np.random.default_rng(log2_n)
    m = 64
    big = rng.uniform(0.5, 1.0, m).astype(np.float32)
    small = (rng.uniform(0.5, 1.0, m) * 2.0 ** -29).astype(np.float32)
    grad = np.concatenate([small, -big])
    bins_t = torch.from_numpy(np.repeat([0, 1], m).astype(np.int32))[None]
    g = torch.from_numpy(grad)
    scale = CH.fixed_scale(g, g.abs(), 1 << log2_n)
    got = CH.build_histogram_plain(bins_t, g, g.abs(), torch.ones(
        2 * m, dtype=torch.bool), 1, 2, scale)
    step = Fraction(1, int(scale[0]))
    top = max(abs(Fraction(float(v))) for v in grad)
    assert step / 2 <= top * Fraction(2) ** (log2_n - 62)
    for b, vals in enumerate((small, -big)):
        exact = sum(Fraction(float(v)) for v in vals)
        err = abs(int(got[0, b, 0]) * step - exact)
        assert err <= m * step / 2
        if b == 0:
            print(f"n 2^{log2_n}: bin of 2^-29 values off by "
                  f"{float(err / abs(exact)):.3e} of its sum")


# --------------------------------------------------------------------------
# the device-identical exp


def _exp_sweep():
    rng = np.random.default_rng(0)
    return np.concatenate([
        rng.normal(0.0, 10.0, 1 << 16), rng.uniform(-110.0, 95.0, 1 << 14),
        np.linspace(-104.5, 89.5, 4097),
        [0.0, -0.0, 1e-30, -1e-30, 88.7228, 88.7229, -87.33, -103.97,
         np.inf, -np.inf, np.nan]]).astype(np.float32)


def test_exp_is_within_an_ulp_of_the_f64_exp():
    x = _exp_sweep()
    got = TO.exp(torch.from_numpy(x)).numpy()
    with np.errstate(over="ignore", invalid="ignore"):
        ref = np.exp(x.astype(np.float64))
        r32 = ref.astype(np.float32)
    fin = np.isfinite(r32) & (r32 > 0)
    ulp = np.spacing(r32[fin]).astype(np.float64)
    assert np.all(np.abs(got[fin].astype(np.float64) - ref[fin]) <= ulp)
    # overflow, underflow, nan: as the f32 rounding of the f64 exp
    np.testing.assert_array_equal(got[~fin], r32[~fin])


def test_exp_gives_the_same_bits_in_every_layout():
    x = torch.from_numpy(_exp_sweep())
    whole = TO.exp(x)
    one_by_one = torch.stack([TO.exp(x[i:i + 1])[0]
                              for i in range(0, len(x), 7)])
    assert torch.equal(one_by_one.view(torch.int32),
                       whole[::7].view(torch.int32))
    strided = TO.exp(x[1::3])
    assert torch.equal(strided.view(torch.int32),
                       whole[1::3].view(torch.int32))
    grid = x[:(len(x) // 8) * 8].reshape(-1, 8).t()   # non-contiguous 2-D
    assert torch.equal(TO.exp(grid).view(torch.int32),
                       whole[:(len(x) // 8) * 8].reshape(-1, 8).t()
                       .view(torch.int32))
    assert TO.exp(x.double()).dtype == torch.float64


def test_softmax_sums_left_to_right():
    raw = torch.from_numpy(np.random.default_rng(1).normal(
        size=(50, 10)).astype(np.float32))
    p = TO.softmax(raw)
    e = TO.exp(raw - raw.amax(dim=1, keepdim=True))
    total = e[:, 0]
    for k in range(1, 10):
        total = total + e[:, k]
    assert torch.equal(p, e / total[:, None])
    # a row alone: the same bits
    assert torch.equal(TO.softmax(raw[7:8]), p[7:8])


# --------------------------------------------------------------------------
# whole fits


def _multiclass_rows(n=600, f=12, k=10, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    centers = rng.normal(size=(k, f))
    y = np.argmax(X @ centers.T + rng.gumbel(size=(n, k)), axis=1)
    X[::17, 2] = np.nan
    return X, y


def assert_same_booster(a, b, X):
    assert len(a.trees) == len(b.trees)
    for it, (ta, tb) in enumerate(zip(a.trees, b.trees)):
        for k, (x, z) in enumerate(zip(ta, tb)):
            assert x.n_nodes == z.n_nodes, (it, k)
            for name in TREE_FIELDS:
                np.testing.assert_array_equal(
                    getattr(x, name), getattr(z, name),
                    err_msg=f"iteration {it} output {k}: {name}")
    pa, pb = a.predict(X), b.predict(X)
    assert pa.dtype == pb.dtype and np.array_equal(pa, pb)


@pytest.mark.parametrize("fused", [True, False])
def test_multiclass_fit_is_bitwise_the_same_from_permuted_rows(fused):
    """10 classes, 15 iterations, no sampling, from the rows in two
    orders: the histograms' sums, the softmax's gradients and so every
    split, leaf value and prediction are the same bits. ``fused`` False
    runs the per-iteration loop (a log line every 15 iterations)."""
    X, y = _multiclass_rows()
    p = TG.BoosterParams(objective="multiclass", num_class=10,
                         num_iterations=15, num_leaves=7, min_data_in_leaf=5)
    loop = {} if fused else {"log_every": 15}
    perm = np.random.default_rng(5).permutation(len(y))
    a = TG.Booster.train(p, X, y, device="cpu", **loop)
    b = TG.Booster.train(p, X[perm], y[perm], device="cpu", **loop)
    assert len(a.trees) == 15
    assert_same_booster(a, b, X)


def _two_scales_rows(n, seed=8):
    """L2 rows in two regions: where ``X[:, 0] > 0`` the label is +-1 by
    the sign of ``X[:, 1]``, half each (pure leaves after a split or two);
    elsewhere about 2^-30, so those rows' gradients lie 30 binades below
    the largest and their leaves' sums round on the fixed point's grid,
    whose last bit then shows in their leaf values."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    big = np.flatnonzero(X[:, 0] > 0)
    y = 2.0 ** -30 * (X[:, 2] + 0.3 * rng.normal(size=n))
    order = big[np.argsort(X[big, 1])]
    y[order[:len(order) // 2]] = -1.0
    y[order[len(order) // 2:]] = 1.0
    if len(order) % 2:
        y[order[-1]] = 2.0 ** -30
    return X, y


#: (learner, data axis size, rows, data). At 1024 rows a {"data": 3}
#: axis pads the rows to 1026, past a power of two: the fixed point must
#: come from the fit's real rows, as on one device
HOSTED = [("data", 2, 453, "multiclass"), ("feature", 2, 453, "multiclass"),
          ("data", 3, 1024, "two_scales"), ("feature", 3, 1024, "two_scales")]


@pytest.mark.parametrize("learner,d,n,data", HOSTED)
def test_hosted_learner_is_bitwise_the_single_device_fit(learner, d, n,
                                                         data):
    if data == "multiclass":
        X, y = _multiclass_rows(n=n, k=3, seed=8)
        kw = dict(objective="multiclass", num_class=3)
    else:
        X, y = _two_scales_rows(n)
        kw = dict(objective="regression")
    kw.update(num_iterations=4, num_leaves=7, min_data_in_leaf=5,
              tree_learner=learner)
    single = TG.Booster.train(TG.BoosterParams(**kw), X, y, device="cpu")
    mesh = TP.build_mesh(TP.MeshSpec.from_dict({"data": d}), "cpu")
    sharded = TG.Booster.train(TG.BoosterParams(**kw), X, y, sharding=mesh)
    assert_same_booster(sharded, single, X)


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, init, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
import mmlspark_tpu_torch.gbdt as TG
from mmlspark_tpu_torch.parallel import topology as TP
mesh = TP.build_mesh(TP.MeshSpec.from_dict({"data": 2}), "cpu")
assert not mesh.hosted
arrays = np.load(data)
models = {}
for name, (kw, loop) in json.loads(sys.argv[5]).items():
    models[name] = TG.Booster.train(
        TG.BoosterParams(**kw), arrays["X"], arrays["y"], sharding=mesh,
        **loop).model_to_string()
with open(out, "w") as f:
    json.dump(models, f)
dist.destroy_process_group()
"""

_GLOO_PARAMS = dict(objective="multiclass", num_class=3, num_iterations=4,
                    num_leaves=7, min_data_in_leaf=5)
#: (params, Booster.train's loop arguments): the fused loop, and the
#: per-iteration loop (a log line every 4 iterations)
GLOO = {"fused": (_GLOO_PARAMS, {}),
        "per_iteration": (_GLOO_PARAMS, {"log_every": 4})}


def test_data_learner_over_gloo_is_bitwise_the_single_device_fit(tmp_path):
    """Two processes, one rank each on ``{"data": 2}`` (453 rows, padded
    to 454): each process's histograms summed over gloo in int64 on the
    grid of every process's largest |v|, the same trees, leaf values and
    predictions as one device's fit of all the rows."""
    X, y = _multiclass_rows(n=453, k=3, seed=8)
    init = f"file://{tmp_path / 'rdv'}"
    data = str(tmp_path / "data.npz")
    np.savez(data, X=X, y=y.astype(np.float64))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), init, data,
         str(tmp_path / f"r{r}.json"), json.dumps(GLOO)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path)) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the gloo ranks did not finish within 120 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    got = [json.load(open(tmp_path / f"r{r}.json")) for r in range(2)]
    assert got[0] == got[1]
    for name, (kw, loop) in GLOO.items():
        single = TG.Booster.train(TG.BoosterParams(**kw), X, y,
                                  device="cpu", **loop)
        rank = TG.Booster.from_string(got[0][name], device="cpu")
        assert_same_booster(rank, single, X)
