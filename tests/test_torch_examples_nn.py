"""The port's network examples (``mmlspark_tpu_torch.examples``) against
the JAX package's scripts under ``examples/`` and the same pipelines
composed from the JAX package, on the CPU at small sizes.

- The data generators give the arrays the JAX scripts build (the
  sequence tagger's ``make_streams`` and ``tag_of`` imported from the
  JAX script; the others recorded from its ``main``).
- The zoo's networks score and featurize as the JAX package's do, within
  1e-4 (scaled: / max(1, |ref|)), the zoo goldens' tolerance.
- The trained examples start from JAX's initial weights (bridged leaf
  for leaf) and their losses and parameters after a few steps are within
  1e-5 of JAX's (over max(1, the largest value)); the conv net's
  parameters within 1e-4 (``CONV_PARAM_TOL``).
"""

from __future__ import annotations

import copy
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.models.function import NNFunction as JF

from mmlspark_tpu_torch.examples import (
    _zoo, cifar10_resnet_scoring, distributed_sgd, multiclass_image_transfer,
    opencv_image_pipeline, sequence_tagging, transfer_learning)
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.function import flatten_params

from test_torch_examples_gbdt import (
    assert_columns_equal, jax_example, jax_example_frames)

torch.set_num_threads(1)

ZOO_TOL = 1e-4       # the zoo goldens' (tests/test_zoo.py)
TRAIN_TOL = 1e-5     # losses and parameters after a few steps
# the conv net's parameters after two steps: the first step's are
# bitwise JAX's, the second's differ by up to 6.9e-5 (the convolutions'
# and GroupNorm's sums in other orders, through the momentum); the
# losses stay within TRAIN_TOL. tests/test_torch_trainer.py's PARAM_TOL.
CONV_PARAM_TOL = 1e-4


def scaled(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|): chip_smoke.py's frame_err."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def rel(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|): tests/test_torch_trainer.py's
    ``rel``."""
    return scaled(got, ref)


def jax_zoo(name):
    from mmlspark_tpu.models.zoo import ModelDownloader
    with tempfile.TemporaryDirectory() as cache:
        d = ModelDownloader(cache, repo=_zoo.ZOO)
        return d.list_models()[name], d.load(name)


# ---------------------------------------------------------------------------
# the generators


def test_streams_are_the_jax_scripts():
    ref = jax_example("sequence_tagging")
    for w in range(0, 160):
        assert sequence_tagging.tag_of(w) == ref.tag_of(w)
    for n, length in ((64, 65), (32, 65), (5, 8), (3, 7)):
        a = sequence_tagging.make_streams(np.random.default_rng(n), n,
                                          length)
        b = ref.make_streams(np.random.default_rng(n), n, length)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for name in ("DRUG", "DISEASE", "OTHER", "TAG_O", "TAG_DRUG",
                 "TAG_DIS", "VOCAB"):
        assert getattr(sequence_tagging, name) == getattr(ref, name)


def test_sgd_frame_is_the_jax_scripts(monkeypatch):
    ref, = jax_example_frames(monkeypatch, "distributed_sgd")
    X, y = distributed_sgd.make_data()
    assert_columns_equal({"features": X, "label": y}, ref)


def test_digits_split_is_the_jax_scripts(monkeypatch):
    ref, = jax_example_frames(monkeypatch, "transfer_learning")
    images, y = transfer_learning.digits_8_vs_9()
    n_tr = len(images) // 2
    assert_columns_equal({"image": images[:n_tr], "label": y[:n_tr]}, ref)


def test_upscaled_digits_are_the_jax_scripts(monkeypatch):
    """The port's resize against ``jax.image.resize``: f32 weights summed
    in another order."""
    ref, = jax_example_frames(monkeypatch, "multiclass_image_transfer")
    images, y = multiclass_image_transfer.make_images(device="cpu")
    n_tr = len(images) // 2
    np.testing.assert_array_equal(y[:n_tr], ref["label"])
    np.testing.assert_allclose(images[:n_tr], ref["image"], rtol=0,
                               atol=1e-6)


def test_cifar_draw_is_the_jax_packages():
    from mmlspark_tpu.testing.datagen import synth_cifar as jsynth
    from mmlspark_tpu_torch.testing.datagen import synth_cifar
    for n, seed, classes in ((16, 123_456, tuple(range(10))),
                             (8, 42, (10, 11))):
        a, b = synth_cifar(n, seed=seed, classes=classes), \
            jsynth(n, seed=seed, classes=classes)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_sample_images_are_the_jax_scripts(tmp_path):
    ref = jax_example("opencv_image_pipeline")
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    a = opencv_image_pipeline.write_sample_images(
        str(tmp_path / "p"), np.random.default_rng(0), 12)
    b = ref._write_sample_images(str(tmp_path / "j"),
                                 np.random.default_rng(0), 12)
    np.testing.assert_array_equal(a, b)
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    for f in names:
        assert (tmp_path / "p" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


# ---------------------------------------------------------------------------
# the zoo's networks


def test_cifar_scores_are_jaxs():
    from mmlspark_tpu.models.nn import NNModel as JNN
    from mmlspark_tpu.testing.datagen import synth_cifar
    out = cifar10_resnet_scoring.run(device="cpu", n=48, batch_size=16)
    meta, fn = jax_zoo("cifar10s_resnet20")
    images, labels = synth_cifar(48, seed=123_456)
    ref = JNN(model=fn, input_col="image", output_col="scores",
              batch_size=16, input_dtype=meta.input_dtype).transform(
        JDF({"image": images}))["scores"]
    assert scaled(out["_scores"], ref) <= ZOO_TOL
    assert out["accuracy"] == float((np.asarray(ref).argmax(1)
                                     == labels).mean())


def test_digits32_features_are_jaxs(monkeypatch):
    from mmlspark_tpu.models.featurizer import ImageFeaturizer as JFeat
    out = multiclass_image_transfer.run(device="cpu", n=48,
                                        num_iterations=2)
    _, fn = jax_zoo("digits32_resnet14")
    ref_frames = jax_example_frames(monkeypatch, "multiclass_image_transfer")
    # the JAX script's first 24 of its 600 training images: the port's
    # draw at n 48 is the same permutation's first 48
    train = JDF({"image": ref_frames[0]["image"][:24]})
    ref = JFeat(model=fn, input_col="image", output_col="embedding",
                cut_output_layers=1).transform(train)["embedding"]
    assert scaled(out["_features"], np.stack(list(ref))) <= ZOO_TOL


def _jax_head_fit(feats, y, head_params, epochs):
    from mmlspark_tpu.automl.train import TrainClassifier as JTrain
    from mmlspark_tpu.models.trainer import NNLearner as JLearner
    head = JF(arch=dict(transfer_learning.HEAD), params=head_params)
    return JTrain(model=JLearner(arch=transfer_learning.HEAD, model=head,
                                 epochs=epochs, batch_size=64,
                                 learning_rate=0.2, log_every=0),
                  label_col="label").fit(
        JDF({"embedding": feats, "label": y}))


def test_transfer_heads_are_jaxs():
    """Both zoo backbones' features within 1e-4 of JAX's, then each head,
    started from JAX's initial weights, within 1e-5 of JAX's after 2
    epochs on the same features."""
    from mmlspark_tpu.models.featurizer import ImageFeaturizer as JFeat
    from mmlspark_tpu.parallel.topology import single_device_scope
    from mmlspark_tpu.testing.datagen import synth_cifar
    _, dfn = jax_zoo("digits_resnet8")
    _, cfn = jax_zoo("cifar10s_resnet20")
    rand = (PF.init(dfn.arch, input_shape=(8, 8, 1), seed=3),
            PF.init(cfn.arch, input_shape=(32, 32, 3), seed=3))
    # each head's initial weights from JAX's init, one per feature width
    head_params = {
        k: jax.tree.map(np.asarray, JF.init(
            transfer_learning.HEAD, input_shape=(d,), seed=0).params)
        for k, d in (("digits", 32), ("cifar", 64))}
    out = transfer_learning.run(
        device="cpu", epochs=2, n_cifar=40, gate=False,
        heads={k: PF(arch=dict(transfer_learning.HEAD),
                     params=copy.deepcopy(v))
               for k, v in head_params.items()},
        random_backbones=rand)
    images, y = transfer_learning.digits_8_vs_9()
    n_tr = len(images) // 2
    Xc, yc = synth_cifar(40, seed=42, classes=(10, 11))
    probes = {"pretrained": ("digits", dfn, images[:n_tr], y[:n_tr]),
              "cifar_pretrained": ("cifar", cfn,
                                   Xc[:20].astype(np.float32) / 255.0,
                                   yc[:20])}
    for tag, (width, fn, x, yy) in probes.items():
        _, _, model, feats = out["_runs"][tag]
        ref = np.stack(list(JFeat(model=fn, input_col="image",
                                  output_col="embedding",
                                  cut_output_layers=1).transform(
            JDF({"image": x}))["embedding"]))
        assert scaled(feats, ref) <= ZOO_TOL, tag
        # the head on the port's features in both packages: the
        # comparison is the training, not the featurizer's rounding
        with single_device_scope():
            jm = _jax_head_fit(feats, yy, copy.deepcopy(head_params[width]),
                               2)
        a = flatten_params(jax.tree.map(np.asarray, jm.fitted.model.params))
        b = flatten_params(model.fitted.model.params)
        assert sorted(a) == sorted(b)
        for k in a:
            assert rel(b[k], a[k]) <= TRAIN_TOL, (tag, k)


def test_sgd_steps_are_jaxs(monkeypatch):
    from mmlspark_tpu.models.trainer import NNLearner as JLearner
    from test_torch_trainer import _jax_fit
    arch = distributed_sgd.ARCH
    params = PF.init(arch, (16, 16, 3), seed=1).params
    # each side its own copy: JAX's fit donates the arrays it is handed
    out = distributed_sgd.run(device="cpu", n=64, epochs=1, batch_size=32,
                              init=PF(arch=dict(arch),
                                      params=copy.deepcopy(params)))
    X, y = distributed_sgd.make_data(0, 64)
    jm, jl = _jax_fit(monkeypatch, JLearner(
        arch=arch, model=JF(arch=dict(arch), params=copy.deepcopy(params)),
        epochs=1,
        batch_size=32, learning_rate=0.05, mesh_shape={"data": -1}),
        {"features": X, "label": y})
    assert out["_losses"].shape == jl.shape
    assert rel(out["_losses"], jl) <= TRAIN_TOL
    a = flatten_params(jax.tree.map(np.asarray, jm.model.params))
    b = flatten_params(out["_model"].model.params)
    for k in a:
        assert rel(b[k], a[k]) <= CONV_PARAM_TOL, k


def test_tagger_steps_are_jaxs():
    """Three steps of the tagger on JAX's own ``{"data": -1}`` mesh (the
    script's) from JAX's ``init_params``, against the port's hosted
    ``{"data": -1}`` (one rank) from the same tree."""
    from mmlspark_tpu.models import transformer as JT
    from mmlspark_tpu.parallel import MeshSpec, build_mesh
    ref = jax_example("sequence_tagging")
    jcfg = JT.TransformerConfig(vocab=ref.VOCAB, d_model=64, n_heads=4,
                                d_head=16, d_ff=128, layers_per_stage=2)
    tree = jax.tree.map(np.asarray, JT.init_params(jcfg, seed=0))
    n, seq, steps = 8, 16, 3
    out = sequence_tagging.run(device="cpu", steps=steps, n=n, seq=seq,
                               n_test=4, init=tree, gate=False)
    mesh = build_mesh(MeshSpec.from_dict({"data": -1}))
    streams = ref.make_streams(np.random.default_rng(0), n, seq + 1)
    tokens = jnp.asarray(streams[:, :-1])
    labels = jnp.asarray(streams[:, 1:])
    mask = jnp.ones(tokens.shape, jnp.float32)
    step = JT.build_spmd_train_step(jcfg, mesh, learning_rate=0.3,
                                    momentum=0.9, donate=False)
    p = JT.shard_params(jax.tree.map(jnp.asarray, tree), jcfg, mesh)
    v = JT.shard_params(jax.tree.map(jnp.zeros_like, p), jcfg, mesh)
    losses = []
    for _ in range(steps):
        p, v, loss = step(p, v, tokens, labels, mask)
        losses.append(float(loss))
    assert rel(out["_losses"], losses) <= TRAIN_TOL
    want = jax.tree.map(np.asarray, jax.device_get(p))
    for a, b in zip(jax.tree.leaves(out["_params"]), jax.tree.leaves(want)):
        assert rel(a, b) <= TRAIN_TOL
    # the held-out scoring reads the same logits (dense reference)
    test = ref.make_streams(np.random.default_rng(7), 4, seq + 1)
    jl = np.asarray(JT.reference_logits(want, jnp.asarray(test[:, :-1]),
                                        jcfg))
    assert scaled(out["_logits"], jl) <= ZOO_TOL


def test_opencv_chain_is_jaxs():
    """The image chain within 1e-5 of JAX's on the same files (the
    CPU's resize and blur sum in other orders), the unrolled features
    likewise."""
    from mmlspark_tpu.io.images import read_images as jread
    from mmlspark_tpu.stages.image import ImageTransformer as JIT
    from mmlspark_tpu.stages.image import UnrollImage as JUnroll
    out = opencv_image_pipeline.run(device="cpu", n_images=16,
                                    num_iterations=3)
    with tempfile.TemporaryDirectory() as root:
        opencv_image_pipeline.write_sample_images(
            root, np.random.default_rng(0), 16)
        df = jread(root)
        df = df.take(np.argsort([str(p) for p in df["path"]]))
        chain = (JIT(input_col="image", output_col="processed")
                 .resize(40, 40).center_crop(32, 32)
                 .gaussian_kernel(3, 1.0).flip()
                 .normalize(mean=[127.5] * 3, std=[127.5] * 3))
        proc = chain.transform(df)
        feats = JUnroll(input_col="processed",
                        output_col="features").transform(proc)["features"]
    np.testing.assert_allclose(out["_processed"],
                               np.stack(list(proc["processed"])),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["_features"], np.stack(list(feats)),
                               rtol=0, atol=1e-5)
    assert out["accuracy"] > 0.9


def test_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (sequence_tagging, distributed_sgd, cifar10_resnet_scoring):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
