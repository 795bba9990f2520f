"""The port's frame trainer (``mmlspark_tpu_torch/models/trainer.py``:
``make_loss``, ``make_optimizer``, the schedules, ``NNLearner``) against
the JAX package's on the same numpy inputs, on the CPU.

* Losses against optax at 1e-6 relative.
* Optimizers against optax over 5 updates, every rule with clipping on
  and off (a norm above the limit included) under each schedule, the
  rate checked at every count: 1e-6 x max(1, |ref|) on the parameters.
* ``NNLearner`` fits against JAX's on bridged initial weights (``model=``)
  in f32, JAX run under ``single_device_scope()`` so both take one data
  shard: 1e-5 relative on every step's loss, 1e-4 x max(1, |ref|) on the
  parameters. JAX's step losses are read by wrapping its jitted step.
* ``flip_crop`` matches JAX's in distribution only (a ``torch.Generator``
  draws it): its properties are held instead.
"""

import io
import threading
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.core import tracing as JTR
from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.models import trainer as JT
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.parallel.topology import single_device_scope
from mmlspark_tpu_torch.core import tracing as PTR
from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.core.telemetry import REGISTRY
from mmlspark_tpu_torch.models import trainer as PT
from mmlspark_tpu_torch.models.function import (
    NNFunction as PF, flatten_params,
)
from mmlspark_tpu_torch.models.nn import NNModel

torch.set_num_threads(1)

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("name", PT.LOSSES)
def test_make_loss_matches_optax(name):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 5)).astype(np.float32) * 3
    if name == "softmax_cross_entropy":
        labels = rng.integers(0, 5, 16).astype(np.int64)
    elif name == "sigmoid_cross_entropy":
        labels = rng.integers(0, 2, 16).astype(np.float32)
    else:
        labels = rng.standard_normal(16).astype(np.float32)
    for w in (np.ones(16, np.float32),
              rng.uniform(0, 2, 16).astype(np.float32),
              np.r_[np.ones(10), np.zeros(6)].astype(np.float32),
              np.zeros(16, np.float32)):
        ref = float(JT.make_loss(name)(logits, labels, w))
        got = float(PT.make_loss(name)(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       torch.from_numpy(w)))
        assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref)), (got, ref)


def test_softmax_loss_truncates_float_labels_as_jax_does():
    logits = np.arange(12, dtype=np.float32).reshape(4, 3) / 5
    labels = np.array([0.0, 1.9, 2.2, 1.0], np.float32)
    w = np.ones(4, np.float32)
    ref = float(JT.make_loss("softmax_cross_entropy")(logits, labels, w))
    got = float(PT.make_loss("softmax_cross_entropy")(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(w)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_unknown_loss_and_optimizer_raise():
    with pytest.raises(ValueError, match="unknown loss"):
        PT.make_loss("hinge")
    with pytest.raises(ValueError, match="unknown optimizer"):
        PT.make_optimizer("lamb", 0.1)


# -- schedules ----------------------------------------------------------------

SCHEDULES = {
    "constant": (lambda: 0.05, lambda: 0.05),
    "warmup_cosine": (
        lambda: optax.warmup_cosine_decay_schedule(0.0, 0.05, 2, 7),
        lambda: PT.warmup_cosine_decay_schedule(0.0, 0.05, 2, 7)),
    "cosine_no_warmup": (
        lambda: optax.warmup_cosine_decay_schedule(0.0, 0.05, 1, 5),
        lambda: PT.warmup_cosine_decay_schedule(0.0, 0.05, 1, 5)),
    "linear": (lambda: optax.linear_schedule(0.0, 0.05, 3),
               lambda: PT.linear_schedule(0.0, 0.05, 3)),
}


@pytest.mark.parametrize("kind", ["warmup_cosine", "cosine_no_warmup",
                                  "linear"])
def test_schedules_match_optax_at_every_count(kind):
    ref_fn, got_fn = SCHEDULES[kind][0](), SCHEDULES[kind][1]()
    for count in range(12):
        ref = float(ref_fn(np.int32(count)))
        assert abs(got_fn(count) - ref) <= 1e-9 + 1e-6 * abs(ref), count
    if kind == "cosine_no_warmup":
        assert got_fn(0) == 0.0     # the first step's rate


@pytest.mark.parametrize("cosine,warmup,expect", [
    (True, 0, [0.0, 0.1]), (True, 3, [0.0, 0.1 / 3]),
    (False, 2, [0.0, 0.05]), (False, 0, [0.1, 0.1])])
def test_learner_schedule_is_jaxs(cosine, warmup, expect):
    kw = dict(learning_rate=0.1, epochs=2, cosine_decay=cosine,
              warmup_steps=warmup)
    ref = JT.NNLearner(**kw)._schedule(4)
    got = PT.NNLearner(**kw)._schedule(4)
    # a constant rate is a number in both packages (optax keeps no count)
    assert callable(got) == callable(ref)

    def rate(count):
        return got(count) if callable(got) else got
    for count in range(10):
        r = float(ref(np.int32(count))) if callable(ref) else ref
        assert abs(rate(count) - r) <= 1e-9 + 1e-6 * abs(r)
    assert rate(0) == pytest.approx(expect[0], rel=1e-6, abs=1e-9)
    assert rate(1) == pytest.approx(expect[1], rel=1e-6)


# -- optimizers ---------------------------------------------------------------

def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("clip", [0.0, 0.5, 100.0])
@pytest.mark.parametrize("name", PT.OPTIMIZERS)
def test_optimizer_matches_optax_over_five_updates(name, clip, schedule):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    ref_lr, got_lr = SCHEDULES[schedule][0](), SCHEDULES[schedule][1]()
    tx = JT.make_optimizer(name, ref_lr, 0.9, 1e-4, clip)
    state = tx.init(params)
    jp = dict(params)
    ours = PT.make_optimizer(name, got_lr, 0.9, 1e-4, clip)
    pp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    ptrs = [p.data_ptr() for p in pp]
    pstate = ours.init(pp)
    for i, g in enumerate(grads):
        if callable(ref_lr):
            assert abs(ours.schedule(i) - float(ref_lr(np.int32(i)))) <= 1e-9
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        ours.step(pp, [torch.from_numpy(g[k]) for k in ("a", "b")], pstate)
        for k, p in zip(("a", "b"), pp):
            assert rel(p.numpy(), jp[k]) <= 1e-6, (i, k)
    assert [p.data_ptr() for p in pp] == ptrs
    assert pstate["count"] == 5


def test_clipping_engages_only_above_the_limit():
    g = [torch.tensor([3.0, 4.0])]                   # norm 5
    for clip, want in ((10.0, [3.0, 4.0]), (5.0, [3.0, 4.0]),
                       (1.0, [0.6, 0.8])):
        p = [torch.zeros(2)]
        opt = PT.make_optimizer("sgd", 1.0, clip_norm=clip)
        opt.step(p, g, opt.init(p))
        np.testing.assert_allclose(-p[0].numpy(), want, rtol=1e-6)


def test_adamw_decays_by_the_params_default():
    assert PT.NNLearner().weight_decay == 1e-4
    p = [torch.ones(3)]
    opt = PT.make_optimizer("adamw", 0.0)
    opt.step(p, [torch.zeros(3)], opt.init(p))
    np.testing.assert_array_equal(p[0].numpy(), 1.0)   # rate 0: no move


# -- NNLearner fits against JAX's ---------------------------------------------

MLP = {"builder": "mlp", "hidden": [16], "num_outputs": 3}
MLP1 = {"builder": "mlp", "hidden": [8], "num_outputs": 1}
RESNET = {"builder": "cifar_resnet", "depth": 8, "width": 4,
          "num_classes": 3}


def _frame(arch, n, uint8, weights, seed=0):
    rng = np.random.default_rng(seed)
    shape = (8, 8, 3) if arch["builder"] == "cifar_resnet" else (5,)
    if uint8:
        x = rng.integers(0, 256, (n, *shape)).astype(np.uint8)
    else:
        x = rng.standard_normal((n, *shape)).astype(np.float32)
    if arch.get("num_outputs") == 1:
        y = rng.standard_normal(n).astype(np.float32)
    else:
        y = rng.integers(0, 3, n).astype(np.int64)
    cols = {"features": x, "label": y}
    if weights:
        cols["w"] = rng.uniform(0.2, 2.0, n).astype(np.float32)
    return cols, shape


def np_init(arch, shape, seed):
    """Initial weights as a numpy tree in flax's layout, for both sides
    (JAX's fit donates the arrays it is handed, so each side builds its
    own from these). The port's ``NNFunction.init`` draws them: JAX's
    first ResNet init compiles for about 15 s."""
    return PF.init(arch, shape, seed=seed).params


def _jax_fit(monkeypatch, learner, cols):
    """JAX's fit, with every step's loss read through its jitted step."""
    seen = []
    real = jax.jit

    def recording(fn, *a, **k):
        jitted = real(fn, *a, **k)
        if getattr(fn, "__name__", "") not in ("step", "epoch_fn"):
            return jitted

        def call(*args):
            out = jitted(*args)
            seen.append(np.ravel(np.asarray(out[2])))
            return out
        return call
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", recording)
        with single_device_scope():
            model = learner.fit(JDF(cols))
    return model, np.concatenate(seen)


FITS = {
    "mlp_host_float": (MLP, False, False, {}),
    "mlp_host_weights_adam": (MLP, False, True, dict(optimizer="adam")),
    "mlp_host_ragged_momentum": (MLP, False, False,
                                 dict(batch_size=80, cosine_decay=False)),
    "mlp_resident_uint8_clip": (MLP, True, False,
                                dict(device_resident=True, clip_norm=0.5,
                                     optimizer="adamw")),
    "mlp_resident_float_weights": (MLP, False, True,
                                   dict(device_resident=True,
                                        warmup_steps=2,
                                        cosine_decay=False)),
    "mlp_squared_error_sgd": (MLP1, False, False,
                              dict(loss="squared_error", optimizer="sgd")),
    "mlp_sigmoid_resident": (dict(MLP1), False, False,
                             dict(loss="sigmoid_cross_entropy",
                                  device_resident=True)),
    "resnet_host_uint8": (RESNET, True, False,
                          dict(batch_size=20, epochs=2,
                               cosine_decay=False)),
    "resnet_resident_float_weights": (RESNET, False, True,
                                      dict(batch_size=16, epochs=2,
                                           device_resident=True)),
}


@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_matches_jax(case, monkeypatch):
    arch, uint8, weights, kw = FITS[case]
    n = 40 if arch["builder"] == "cifar_resnet" else 64
    cols, shape = _frame(arch, n, uint8, weights)
    if kw.get("loss") == "sigmoid_cross_entropy":
        cols["label"] = (cols["label"] > 0).astype(np.float32)
    params = np_init(arch, shape, seed=1)
    jf = JF(arch=dict(arch), params=params)
    base = dict(arch=arch, learning_rate=0.05, epochs=3, batch_size=16,
                log_every=0, weight_col="w" if weights else None)
    base.update(kw)
    jm, jl = _jax_fit(monkeypatch, JT.NNLearner(model=jf, **base), cols)
    learner = PT.NNLearner(model=PF(arch=dict(arch), params=params),
                           device="cpu", **base)
    pm = learner.fit(PDF(cols))
    pl = np.concatenate(learner.losses)
    assert pl.shape == jl.shape
    assert np.abs(pl - jl).max() <= LOSS_TOL * np.abs(jl).max(), (pl, jl)
    a = flatten_params(jax.tree.map(np.asarray, jm.model.params))
    b = flatten_params(pm.model.params)
    assert sorted(a) == sorted(b)
    for k in a:
        assert rel(b[k], a[k]) <= PARAM_TOL, k
    assert isinstance(pm, NNModel) and pm.device == "cpu"
    assert pm.input_dtype == jm.input_dtype
    assert pm.input_dtype == ("uint8" if uint8 else "auto")
    # the fitted model scores as JAX's does (the conv nets' scoring is
    # held in tests/test_torch_frame_plane.py; JAX compiles it slowly)
    if arch["builder"] == "mlp":
        x = cols["features"][:8]
        ref = jm.transform(JDF({"features": x}))["scores"]
        got = pm.transform(PDF({"features": x}))["scores"]
        assert rel(got, ref) <= PARAM_TOL


def test_fit_from_arch_and_data_axis_padding(monkeypatch):
    """``model=None`` draws the init from the seed (parity by shapes and
    learning); a data axis of 4 pads a 10-row batch to 12 with weight-0
    rows, which leaves the fit as JAX's two-device fit."""
    cols, _ = _frame(MLP, 10, False, False)
    learner = PT.NNLearner(arch=MLP, epochs=2, batch_size=16, log_every=0,
                           mesh_shape={"data": 4}, device="cpu")
    m = learner.fit(PDF(cols))
    assert m.model.arch == MLP and len(learner.losses) == 2
    params = np_init(MLP, (5,), seed=1)
    jf = JF(arch=dict(MLP), params=params)
    kw = dict(arch=MLP, epochs=2, batch_size=18, log_every=0,
              mesh_shape={"data": 4}, learning_rate=0.05,
              cosine_decay=False)
    jm = JT.NNLearner(model=jf, **kw).fit(JDF(cols))
    pl = PT.NNLearner(model=PF(arch=dict(MLP), params=params),
                      device="cpu", **kw)
    pm = pl.fit(PDF(cols))
    a = flatten_params(jax.tree.map(np.asarray, jm.model.params))
    b = flatten_params(pm.model.params)
    for k in a:
        assert rel(b[k], a[k]) <= PARAM_TOL, k


def test_parameters_stay_in_place_across_steps():
    cols, _ = _frame(MLP, 32, False, False)
    fn = PF.init(MLP, (5,), seed=0)
    module = fn.to_module("cpu")
    learner = PT.NNLearner(device="cpu")
    step = learner.build_train_step(
        module, PT.make_optimizer("momentum", 0.1),
        PT.make_loss("softmax_cross_entropy"))
    ptrs = [p.data_ptr() for p in module.parameters()]
    x = torch.from_numpy(cols["features"])
    y = torch.from_numpy(cols["label"])
    w = torch.ones(32)
    losses = [float(step(x, y, w)) for _ in range(5)]
    assert [p.data_ptr() for p in module.parameters()] == ptrs
    assert losses[-1] < losses[0]
    assert step.state["count"] == 5


def test_max0_gradient_is_jaxs_at_ties():
    """GroupNorm clamps its variance with flax's ``jnp.maximum(0, var)``,
    which passes half the gradient at a tie; ``clamp_min`` would pass
    all of it."""
    from mmlspark_tpu_torch.models.function import max0
    v = np.array([-2.0, -0.0, 0.0, 0.0, 1e-30, 3.0], np.float32)
    r = np.arange(1, 7, dtype=np.float32)
    ref = jax.grad(lambda a: (jax.numpy.maximum(0.0, a) * r).sum())(v)
    vt = torch.from_numpy(v).requires_grad_(True)
    out = max0(vt)
    (got,) = torch.autograd.grad((out * torch.from_numpy(r)).sum(), vt)
    np.testing.assert_array_equal(out.detach().numpy(), np.maximum(0, v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with torch.no_grad():
        np.testing.assert_array_equal(max0(vt).numpy(), np.maximum(0, v))


def test_groupnorm_gradient_at_a_tie_is_jaxs():
    """Two values whose f32 statistics give ``E[x^2] - E[x]^2`` exactly
    0 though they differ by one ulp: the tie, through a whole GroupNorm
    backward, against flax's."""
    import flax.linen as fnn
    from mmlspark_tpu_torch.models.function import GroupNorm
    pair = np.array([1.0, 1.000000238418579], np.float32)
    x = np.stack([pair, pair[::-1] * 3], axis=-1).reshape(1, 1, 2, 2)
    r = np.random.default_rng(0).standard_normal(x.shape).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=2, epsilon=1e-6)
    variables = gn.init(jax.random.PRNGKey(0), x)
    ref = jax.grad(lambda v: (gn.apply(variables, v) * r).sum())(x)
    layer = GroupNorm()
    layer.load_flax({"scale": np.ones(2, np.float32),
                     "bias": np.zeros(2, np.float32)}, torch.device("cpu"))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad((layer(xt) * torch.from_numpy(r)).sum(),
                                 xt)
    assert np.abs(np.asarray(ref)).max() > 1.0     # the tie matters here
    assert rel(got.numpy(), ref) <= 1e-5


# -- flip_crop ----------------------------------------------------------------

def test_flip_crop_rows_are_windows_of_the_reflect_padded_image():
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (64, 32, 32, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    out = PT.NNLearner._augment_flip_crop(gen, torch.from_numpy(x)).numpy()
    assert out.shape == x.shape
    padded = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    flipped = np.pad(x[:, :, ::-1], ((0, 0), (4, 4), (4, 4), (0, 0)),
                     mode="reflect")
    for i in range(len(x)):
        found = [(f, r, c) for f, src in ((0, padded), (1, flipped))
                 for r in range(9) for c in range(9)
                 if np.array_equal(out[i], src[i, r:r + 32, c:c + 32])]
        assert found, i


def test_flip_crop_draws_are_uniform_and_seeded():
    n = 4000
    x = torch.arange(n * 10 * 10, dtype=torch.float32).reshape(
        n, 10, 10, 1) % 997
    gen = torch.Generator().manual_seed(11)
    out = PT.NNLearner._augment_flip_crop(gen, x)
    # recover each row's flip and offsets from its first row of pixels
    xn = x.numpy()
    padded = np.pad(xn, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="reflect")
    padded_f = np.pad(xn[:, :, ::-1], ((0, 0), (4, 4), (4, 4), (0, 0)),
                      mode="reflect")
    flips, rows, cols = [], [], []
    o = out.numpy()
    for i in range(0, n, 4):
        for f, src in ((0, padded), (1, padded_f)):
            hit = [(r, c) for r in range(9) for c in range(9)
                   if np.array_equal(o[i], src[i, r:r + 10, c:c + 10])]
            if hit:
                flips.append(f)
                rows.append(hit[0][0])
                cols.append(hit[0][1])
                break
    m = len(flips)
    assert m == n // 4
    # binomial bounds at about 5 standard deviations
    assert abs(np.mean(flips) - 0.5) <= 5 * np.sqrt(0.25 / m)
    for axis in (rows, cols):
        counts = np.bincount(axis, minlength=9) / m
        assert np.all(np.abs(counts - 1 / 9) <= 5 * np.sqrt(
            (1 / 9) * (8 / 9) / m))
    again = PT.NNLearner._augment_flip_crop(
        torch.Generator().manual_seed(11), x)
    assert torch.equal(out, again)


def test_resident_flip_crop_fit_is_seeded():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (48, 8, 8, 3)).astype(np.uint8)
    y = rng.integers(0, 3, 48)
    fn = PF.init(RESNET, (8, 8, 3), seed=0)

    def fit():
        lr = PT.NNLearner(model=fn, epochs=2, batch_size=16, log_every=0,
                          device_resident=True, augment="flip_crop",
                          device="cpu")
        m = lr.fit(PDF({"features": x, "label": y}))
        return np.concatenate(lr.losses), m
    a, ma = fit()
    b, mb = fit()
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and ma.input_dtype == "uint8"


def test_augment_on_the_host_loop_warns():
    cols, _ = _frame(MLP, 32, False, False)
    with pytest.warns(UserWarning, match="WITHOUT augmentation"):
        PT.NNLearner(arch=MLP, epochs=1, batch_size=16, log_every=0,
                     augment="flip_crop", device="cpu").fit(PDF(cols))


# -- refusals -----------------------------------------------------------------

def _small():
    cols, _ = _frame(MLP, 16, False, False)
    return PDF(cols)


def test_checkpoint_dir_refused(tmp_path):
    """``checkpoint_dir`` is no longer refused: a fit writes its step
    checkpoints (the digest manifest last) and a second fit over the same
    directory resumes from the last of them, reaching the same weights
    (the full checks are in ``tests/test_torch_trainer_chaos.py``)."""
    from mmlspark_tpu_torch.io import checkpoint as PC
    kw = dict(arch=MLP, epochs=2, batch_size=4, log_every=0, device="cpu",
              checkpoint_dir=str(tmp_path), checkpoint_every=3)
    first = PT.NNLearner(**kw).fit(_small())
    assert PC.manager(str(tmp_path)).all_steps() == [3, 6, 8]
    assert PC.verify_digest(str(tmp_path / "step_00000008"),
                            strict=True)[0]
    again = PT.NNLearner(**kw).fit(_small())
    for k, v in flatten_params(first.model.params).items():
        np.testing.assert_array_equal(
            flatten_params(again.model.params)[k], v)


def test_fit_stream_refused():
    """``fit_stream`` is no longer refused: it trains from a memory
    stream (the full checks are in ``tests/test_torch_streaming.py``)."""
    from mmlspark_tpu_torch.streaming import MemoryStreamSource
    cols, _ = _frame(MLP, 16, False, False)
    src = MemoryStreamSource()
    src.add_rows([{"features": x.tolist(), "label": int(y)}
                  for x, y in zip(cols["features"], cols["label"])])
    fit = PT.NNLearner(arch=MLP, batch_size=8, log_every=0,
                       device="cpu").fit_stream(src, max_batch_rows=8)
    assert fit.query.process_available() == 2
    st = fit.status()["trainer"]
    assert st["n_batches_trained"] == 2 and st["n_rows_trained"] == 16
    assert np.isfinite(st["last_loss"])


@pytest.mark.parametrize("axis", ["model", "expert", "pipe"])
def test_model_expert_and_pipe_axes_refused(axis, monkeypatch):
    """The expert and pipe axes are refused outright (JAX's NNLearner has
    neither); the model axis fits on a hosted mesh
    (``tests/test_torch_tp_frame.py``) and hosted in each process of a
    world (``tests/test_torch_process_axes.py``), and one rank per
    process raises JAX's ``ValueError``: its ``put_batch`` refuses a
    data axis that does not divide over the processes."""
    if axis == "model":
        monkeypatch.setattr(torch.distributed, "is_initialized",
                            lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        with pytest.raises(ValueError, match=r"data axis \(1\) not "
                                             r"divisible by process count"):
            PT.NNLearner(arch=MLP, mesh_shape={"data": 1, axis: 2},
                         device="cpu").fit(_small())
        return
    with pytest.raises(NotImplementedError, match="JAX's has neither"):
        PT.NNLearner(arch=MLP, mesh_shape={"data": 1, axis: 2},
                     device="cpu").fit(_small())


def test_a_seq_axis_is_refused_and_size_one_axes_pass():
    with pytest.raises(ValueError, match="data axis only"):
        PT.NNLearner(arch=MLP, mesh_shape={"seq": 2},
                     device="cpu").fit(_small())
    PT.NNLearner(arch=MLP, epochs=1, log_every=0, device="cpu",
                 mesh_shape={"data": -1, "model": 1}).fit(_small())


def test_a_mesh_of_one_rank_per_process_is_refused(monkeypatch):
    """The data axis one rank per process fits (its gloo run:
    ``tests/test_torch_tp_frame.py``), and so do several data ranks a
    process (``tests/test_torch_process_axes.py``); a data axis smaller
    than the world raises ``ValueError``, as the JAX ``build_mesh`` does
    across processes."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(ValueError, match="multi-process world has 2"):
        PT.NNLearner(arch=MLP, mesh_shape={"data": 1},
                     device="cpu").fit(_small())


def test_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.NNLearner(arch=MLP).fit(_small())


def test_a_failed_step_propagates_without_checkpoints():
    calls = []

    def inject(step):
        calls.append(step)
        if step == 3:
            raise RuntimeError("injected")
    with pytest.raises(RuntimeError, match="injected"):
        PT.NNLearner(arch=MLP, epochs=2, batch_size=4, log_every=0,
                     fault_injector=inject, device="cpu").fit(_small())
    assert calls == [1, 2, 3]


# -- telemetry ----------------------------------------------------------------

def _step_count() -> int:
    fam = REGISTRY.histogram("trainer_step_ms")
    return int(fam.stats()["count"])


def test_trainer_metrics_count_every_step():
    before = _step_count()
    PT.NNLearner(arch=MLP, epochs=3, batch_size=4, log_every=0,
                 device="cpu").fit(_small())
    assert _step_count() - before == 12
    text = REGISTRY.render()
    for fam in ("trainer_step_ms", "trainer_examples_per_sec",
                "trainer_checkpoint_save_ms",
                "trainer_checkpoint_restore_ms", "trainer_restarts_total"):
        assert fam in text, fam


def _spans(tracer_mod, learner, frame):
    tr = tracer_mod.Tracer(default_slow_ms=None)
    with tr.span("job") as root:
        if tracer_mod is JTR:
            with single_device_scope():
                learner.fit(frame)
        else:
            learner.fit(frame)
    return [(s.name, {k: v for k, v in (s.attrs or {}).items()
                      if k != "route"})
            for s in tr.recorder.gather(root.trace_id) if s.name != "job"]


@pytest.mark.parametrize("resident", [False, True])
def test_spans_match_jaxs(resident):
    cols, _ = _frame(MLP, 20, False, False)
    kw = dict(arch=MLP, epochs=2, batch_size=8, log_every=0,
              device_resident=resident)
    params = np_init(MLP, (5,), seed=0)
    ref = _spans(JTR, JT.NNLearner(model=JF(arch=dict(MLP), params=params),
                                   **kw), JDF(cols))
    got = _spans(PTR, PT.NNLearner(model=PF(arch=dict(MLP), params=params),
                                   device="cpu", **kw), PDF(cols))
    assert sorted(map(repr, got)) == sorted(map(repr, ref))
    names = {n for n, _ in got}
    assert names == ({"train_epoch"} if resident
                     else {"train_step", "step_dispatch"})


def test_log_every_prints_the_loss():
    buf = io.StringIO()
    with redirect_stdout(buf):
        PT.NNLearner(arch=MLP, epochs=1, batch_size=4, log_every=2,
                     device="cpu").fit(_small())
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[NNLearner] step")]
    assert len(lines) == 2 and "loss" in lines[0]


def test_push_gateway_gets_the_final_flush():
    bodies = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            bodies.append(self.rfile.read(n).decode())
            self.send_response(200)
            self.end_headers()

        def do_PUT(self):
            self.do_POST()

        def log_message(self, *a):
            pass
    srv = HTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/metrics/job/train"
        PT.NNLearner(arch=MLP, epochs=1, batch_size=8, log_every=0,
                     push_gateway_url=url, push_interval_s=60.0,
                     device="cpu").fit(_small())
    finally:
        srv.shutdown()
        srv.server_close()
    assert bodies and "trainer_step_ms" in bodies[-1]


# -- persistence --------------------------------------------------------------

def test_learner_and_fitted_model_round_trip(tmp_path):
    cols, _ = _frame(MLP, 32, True, False)
    learner = PT.NNLearner(arch=MLP, epochs=1, batch_size=8, log_every=0,
                           optimizer="adam", clip_norm=1.0, device="cpu")
    learner.save(str(tmp_path / "learner"))
    back = PipelineStage.load(str(tmp_path / "learner"), device="cpu")
    assert isinstance(back, PT.NNLearner) and back.device == "cpu"
    assert back.get_param_values() == learner.get_param_values()
    model = back.fit(PDF(cols))
    model.save(str(tmp_path / "model"))
    loaded = PipelineStage.load(str(tmp_path / "model"), device="cpu")
    assert loaded.input_dtype == "uint8"
    np.testing.assert_array_equal(
        loaded.transform(PDF(cols))["scores"],
        model.transform(PDF(cols))["scores"])
