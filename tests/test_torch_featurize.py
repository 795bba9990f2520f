"""The port's features (``mmlspark_tpu_torch`` ``featurize/``,
``automl/train.py``, ``models/featurizer.py``) against the JAX
package's on the same numpy inputs, on the CPU.

Host-side featurization (hashing, tokens, TF-IDF, assembly, ``Featurize``)
is numpy in both packages and must be equal. ``Word2Vec`` trains by
autograd SGD on tensors from JAX's numpy stream: vectors within 1e-5 x
max(1, |ref|) (f32, the gathers' gradients summed in another order).
``TrainClassifier``/``TrainRegressor`` fits are held by the GBDT tie
rule (``tests/test_torch_gbdt.py`` ``assert_same_fit``).
``ImageFeaturizer`` rows on the zoo's models: 1e-5 x max(1, |ref|) (f32
nets, as ``tests/test_torch_frame_plane.py`` holds them); 3e-5 after a
resize to ``input_shape``, whose f32 contraction rounds otherwise than
JAX's and which ResNet-20 then magnifies (measured 1.1e-5 on
``cifar10s_resnet20``, below 1e-5 on the other two).
"""

import datetime as dt
import os

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.automl import train as JA
from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.featurize import assemble as JFA
from mmlspark_tpu.featurize import text as JTX
from mmlspark_tpu.gbdt import stages as JG
from mmlspark_tpu.models.featurizer import ImageFeaturizer as JIF
from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.parallel.topology import single_device_scope
from mmlspark_tpu_torch.automl import (
    TrainClassifier, TrainedClassifierModel, TrainRegressor,
    TrainedRegressorModel,
)
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.dataframe import DataFrame as PDF
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.featurize import assemble as PFA
from mmlspark_tpu_torch.featurize import text as PTX
from mmlspark_tpu_torch.gbdt import booster as TB
from mmlspark_tpu_torch.gbdt import stages as PG
from mmlspark_tpu_torch.models import ImageFeaturizer
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.zoo import ModelDownloader

from test_torch_gbdt import assert_same_fit

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
RESIZED_TOL = 3e-5


def err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def same_frames(got, ref):
    assert got.columns == ref.columns
    for name in ref.columns:
        a, b = got[name], ref[name]
        if a.dtype == np.dtype("O") or b.dtype == np.dtype("O"):
            assert [list(x) if isinstance(x, (list, np.ndarray)) else x
                    for x in a] == \
                [list(x) if isinstance(x, (list, np.ndarray)) else x
                 for x in b], name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.get_metadata(name) == ref.get_metadata(name), name


TEXTS = ["The quick brown fox jumps over the lazy dog",
         "pack my box with five dozen liquor jugs",
         "sphinx of black quartz, judge my vow!",
         "How vexingly quick daft zebras jump",
         "the the the fox fox dog"]


def both(cols):
    return JDF(dict(cols)), PDF(dict(cols))


# -- text ---------------------------------------------------------------------

@pytest.mark.parametrize("dims", [1, 7, 256, 1 << 12])
def test_hash_token_matches_jax(dims):
    for tok in ["", "fox", "Fox", "été", "a b", "x" * 100]:
        assert PTX.hash_token(tok, dims) == JTX.hash_token(tok, dims)


@pytest.mark.parametrize("stage", [
    lambda m: m.Tokenizer(input_col="t", output_col="o"),
    lambda m: m.Tokenizer(input_col="t", output_col="o", pattern=r"\s+",
                          to_lowercase=False, min_token_length=3),
])
def test_tokenizer_matches_jax(stage):
    j, p = both({"t": TEXTS})
    same_frames(stage(PTX).transform(p), stage(JTX).transform(j))


def _tokens():
    return [t.lower().split() for t in TEXTS]


@pytest.mark.parametrize("make", [
    lambda m: m.StopWordsRemover(input_col="k", output_col="o"),
    lambda m: m.StopWordsRemover(input_col="k", output_col="o",
                                 stop_words=["fox", "my"]),
    lambda m: m.NGram(input_col="k", output_col="o", n=3),
    lambda m: m.MultiNGram(input_col="k", output_col="o", lengths=[1, 2]),
    lambda m: m.HashingTF(input_col="k", output_col="o", num_features=32),
    lambda m: m.HashingTF(input_col="k", output_col="o", num_features=16,
                          binary=True),
])
def test_token_stages_match_jax(make):
    j, p = both({"k": _tokens()})
    same_frames(make(PTX).transform(p), make(JTX).transform(j))


@pytest.mark.parametrize("min_df", [0, 2])
def test_idf_matches_jax(min_df):
    tf = PTX.HashingTF(input_col="k", output_col="tf", num_features=64) \
        .transform(PDF({"k": _tokens()}))["tf"]
    j, p = both({"tf": tf})
    jm = JTX.IDF(input_col="tf", output_col="o", min_doc_freq=min_df).fit(j)
    pm = PTX.IDF(input_col="tf", output_col="o", min_doc_freq=min_df).fit(p)
    assert pm.idf == jm.idf
    same_frames(pm.transform(p), jm.transform(j))


@pytest.mark.parametrize("kw", [
    {}, {"use_stop_words_remover": True, "use_n_gram": True,
         "num_features": 128},
    {"use_idf": False, "binary": True, "num_features": 64},
])
def test_text_featurizer_matches_jax(kw):
    j, p = both({"text": TEXTS})
    jm = JTX.TextFeaturizer(input_col="text", output_col="f", **kw).fit(j)
    pm = PTX.TextFeaturizer(input_col="text", output_col="f", **kw).fit(p)
    same_frames(pm.transform(p), jm.transform(j))


def test_page_splitter_matches_jax():
    text = ("lorem ipsum " * 50 + "x" * 300 + " tail") * 2
    kw = dict(input_col="t", output_col="o", maximum_page_length=120,
              minimum_page_length=100)
    j, p = both({"t": [text, "short", " leading"]})
    same_frames(PTX.PageSplitter(**kw).transform(p),
                JTX.PageSplitter(**kw).transform(j))


def _corpus():
    a = [["cat", "dog", "pet"], ["dog", "cat"], ["pet", "cat", "dog"]] * 6
    b = [["car", "road", "drive"], ["road", "car"],
         ["drive", "car", "road"]] * 6
    return {"tokens": a + b + [["cat", "road", "rare"]]}


@pytest.mark.parametrize("kw", [
    dict(vector_size=8, max_iter=3, batch_size=64, step_size=0.3),
    dict(vector_size=5, window=1, negatives=3, min_count=2, batch_size=50,
         seed=3),
])
def test_word2vec_matches_jax(kw):
    j, p = both(_corpus())
    jm = JTX.Word2Vec(input_col="tokens", output_col="v", **kw).fit(j)
    pm = PTX.Word2Vec(input_col="tokens", output_col="v", device="cpu",
                      **kw).fit(p)
    assert pm.vocab == jm.vocab
    assert err(pm.vectors, jm.vectors) <= F32_TOL
    assert err(pm.transform(p)["v"], jm.transform(j)["v"]) <= F32_TOL
    assert [w for w, _ in pm.find_synonyms("cat", 2)] == \
        [w for w, _ in jm.find_synonyms("cat", 2)]


def test_word2vec_on_an_empty_corpus_and_the_card_default(monkeypatch):
    p = PDF({"tokens": [[], []]})
    m = PTX.Word2Vec(input_col="tokens", vector_size=4, device="cpu").fit(p)
    assert np.asarray(m.vectors).shape == (1, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTX.Word2Vec(input_col="tokens").fit(PDF(_corpus()))


def test_text_featurizer_word2vec_path_matches_jax():
    j, p = both({"text": ["cat dog pet", "car road drive"] * 10})
    kw = dict(input_col="text", output_col="f", use_word2vec=True,
              word2vec_size=8)
    jm = JTX.TextFeaturizer(**kw).fit(j)
    pm = PTX.TextFeaturizer(device="cpu", **kw).fit(p)
    assert err(pm.transform(p)["f"], jm.transform(j)["f"]) <= F32_TOL


# -- assembly and Featurize ---------------------------------------------------

def _mixed():
    rng = np.random.default_rng(0)
    n = 12
    day = dt.datetime(2024, 3, 5, 7, 30, tzinfo=dt.timezone.utc).timestamp()
    dates = np.array([day + 86400 * 37 * i for i in range(n)], object)
    dates[3] = None
    return {
        "num": np.r_[rng.normal(size=n - 2), np.nan, 2.5],
        "ints": rng.integers(0, 9, n),
        "color": rng.choice(["red", "blue", "green"], n).tolist(),
        "text": [" ".join(rng.choice(["alpha", "beta", "gamma", "delta",
                                      f"w{i}"], 6)) for i in range(n)],
        "vec": rng.normal(size=(n, 3)),
        "cat": rng.integers(0, 3, n),
        "when": dates,
        "label": rng.integers(0, 2, n),
    }


def _with_meta(frame_cls, cols):
    df = frame_cls(cols)
    df = df.with_metadata("cat", S.make_categorical_meta(["x", "y", "z"]))
    return df.with_metadata("when", {"datetime": True})


@pytest.mark.parametrize("cats_first", [True, False])
def test_vector_assembler_matches_jax(cats_first):
    cols = _mixed()
    kw = dict(input_cols=["num", "vec", "cat", "ints"], output_col="f",
              cats_first=cats_first)
    ref = JFA.VectorAssembler(**kw).transform(_with_meta(JDF, cols))
    got = PFA.VectorAssembler(**kw).transform(_with_meta(PDF, cols))
    same_frames(got, ref)


@pytest.mark.parametrize("one_hot", [True, False])
@pytest.mark.parametrize("n_feat", [4, 256])
def test_featurize_matches_jax(one_hot, n_feat):
    cols = _mixed()
    kw = dict(feature_columns=["num", "ints", "color", "text", "vec", "cat",
                               "when"], output_col="f",
              number_of_features=n_feat, one_hot_encode_categoricals=one_hot)
    jm = JFA.Featurize(**kw).fit(_with_meta(JDF, cols))
    pm = PFA.Featurize(**kw).fit(_with_meta(PDF, cols))
    assert pm.plans == jm.plans
    same_frames(pm.transform(_with_meta(PDF, cols)),
                jm.transform(_with_meta(JDF, cols)))


# -- TrainClassifier / TrainRegressor -----------------------------------------

GBDT = dict(num_iterations=12, num_leaves=7, min_data_in_leaf=5)


def _binary(n=200, seed=0, levels=("bad", "good")):
    rng = np.random.default_rng(seed)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    label = np.where(x1 + 0.5 * x2 + 0.3 * rng.normal(size=n) > 0,
                     levels[1], levels[0])
    return {"x1": x1, "x2": x2,
            "color": rng.choice(["r", "g", "b"], size=n).tolist(),
            "label": label.tolist()}


def _three_class(n=240, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5])
    return {"emb": x, "label": y}


def _fits(cols, jcls, pcls, jest, pest, label="label"):
    with single_device_scope():
        jm = jcls(model=jest, label_col=label).fit(JDF(dict(cols)))
    pm = pcls(model=pest, label_col=label).fit(PDF(dict(cols)))
    return jm, pm


@pytest.mark.parametrize("data", ["binary_strings", "three_class_vectors"])
def test_train_classifier_matches_jax(data, tmp_path):
    """The port's ``TrainClassifier`` against JAX's: the same plans,
    features and levels, the fit split for split up to a tie, the port's
    transform its own booster's, and its predictions and probabilities
    JAX's. ``three_class_vectors``' fit meets a near-tie that JAX's f32
    argmax and the port's near-tie rule (``gbdt/tree.py`` ``TIE_ULPS``)
    break differently, and the fits part there: its predicted classes
    are still JAX's, its probabilities 0.039 off JAX's (a reading of this
    seeded data; the bracket is 1e-3 to 2x that), and with JAX's trees
    in the port's model the transform is JAX's at 1e-4."""
    cols = _binary() if data == "binary_strings" else _three_class()
    jm, pm = _fits(cols, JA.TrainClassifier, TrainClassifier,
                   JG.GBDTClassifier(**GBDT),
                   PG.GBDTClassifier(device="cpu", **GBDT))
    assert isinstance(pm, TrainedClassifierModel)
    assert pm.levels == jm.levels
    assert pm.featurizer.plans == jm.featurizer.plans
    X = pm.featurizer.transform(PDF(dict(cols)))[pm.features_col]
    np.testing.assert_array_equal(
        X, jm.featurizer.transform(JDF(dict(cols)))[jm.features_col])
    _, tie = assert_same_fit(jm.fitted.booster, pm.fitted.booster, X, X)
    assert (tie is None) == (data == "binary_strings")
    ref = jm.transform(JDF(dict(cols)))
    got = pm.transform(PDF(dict(cols)))
    assert got.columns == ref.columns
    own = pm.fitted.booster.predict(np.asarray(X))
    if own.ndim == 1:
        own = np.stack([1 - own, own], axis=1)
    np.testing.assert_array_equal(np.stack(list(got["probability"])), own)
    assert list(got["prediction"]) == list(ref["prediction"])
    spread = err(got["probability"], ref["probability"])
    if tie is None:
        assert spread <= 1e-4
    else:
        assert 1e-3 < spread < 8e-2
    assert got.get_metadata("prediction") is not None
    assert got.get_metadata("probability")["levels"] == \
        ref.get_metadata("probability")["levels"]
    pm.save(str(tmp_path / "tc"))
    back = PipelineStage.load(str(tmp_path / "tc"), device="cpu")
    assert back.fitted.booster.device.type == "cpu"
    assert list(back.transform(PDF(dict(cols)))["prediction"]) == \
        list(got["prediction"])
    if tie is not None:
        pm.fitted.booster = TB.Booster.from_string(
            jm.fitted.booster.model_to_string(), device="cpu")
        swapped = pm.transform(PDF(dict(cols)))
        assert list(swapped["prediction"]) == list(ref["prediction"])
        assert err(swapped["probability"], ref["probability"]) <= 1e-4


def test_train_regressor_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x1, x2 = rng.normal(size=200), rng.normal(size=200)
    cols = {"x1": x1, "x2": x2, "tag": rng.choice(["a", "b"], 200).tolist(),
            "y": 2.0 * x1 - x2 + 0.1 * rng.normal(size=200)}
    jm, pm = _fits(cols, JA.TrainRegressor, TrainRegressor,
                   JG.GBDTRegressor(**GBDT),
                   PG.GBDTRegressor(device="cpu", **GBDT), label="y")
    assert isinstance(pm, TrainedRegressorModel)
    X = pm.featurizer.transform(PDF(dict(cols)))[pm.features_col]
    assert_same_fit(jm.fitted.booster, pm.fitted.booster, X, X)
    ref = jm.transform(JDF(dict(cols)))
    got = pm.transform(PDF(dict(cols)))
    assert got.columns == ref.columns
    assert err(got["prediction"], ref["prediction"]) <= 1e-4
    pm.save(str(tmp_path / "tr"))
    back = PipelineStage.load(str(tmp_path / "tr"), device="cpu")
    np.testing.assert_array_equal(back.transform(PDF(dict(cols)))[
        "prediction"], got["prediction"])


def test_train_classifier_keeps_the_inner_stages_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainClassifier(model=PG.GBDTClassifier(**GBDT),
                        label_col="label").fit(PDF(_binary(60)))


# -- ImageFeaturizer ----------------------------------------------------------

ZOO = ["digits_resnet8", "digits32_resnet14", "cifar10s_resnet20"]


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    dl = ModelDownloader(str(tmp_path_factory.mktemp("zoo")),
                         repo=os.path.join(REPO, "zoo"))
    return {name: dl.download_by_name(name) for name in ZOO}


@pytest.mark.parametrize("cut", [1, 2])
@pytest.mark.parametrize("name", ZOO)
def test_image_featurizer_matches_jax_on_the_zoo(zoo, name, cut):
    meta = zoo[name]
    h, w, c = meta.input_shape
    x = np.random.default_rng(0).uniform(0, 1, (5, h, w, c)).astype(
        np.float32)
    kw = dict(input_col="image", output_col="f", cut_output_layers=cut,
              batch_size=4)
    ref = JIF(model=JF.load(meta.uri), **kw).transform(JDF({"image": x}))
    got = ImageFeaturizer(model=PF.load(meta.uri), device="cpu", **kw) \
        .transform(PDF({"image": x}))
    assert got.columns == ref.columns
    assert err(got["f"], ref["f"]) <= F32_TOL


@pytest.mark.parametrize("name", ZOO)
def test_image_featurizer_resizes_to_the_input_shape(zoo, name):
    meta = zoo[name]
    h, w, c = meta.input_shape
    rng = np.random.default_rng(1)
    rows = [rng.uniform(0, 1, (h + 5, w - 3, c)).astype(np.float32),
            rng.uniform(0, 1, (2 * h, 2 * w, c)).astype(np.float32),
            None,
            rng.uniform(0, 1, (h + 5, w - 3, c)).astype(np.float32)]

    def col():
        out = np.empty(len(rows), dtype=object)
        out[:] = rows
        return out
    kw = dict(input_col="image", output_col="f", cut_output_layers=1,
              input_shape=list(meta.input_shape))
    ref = JIF(model=JF.load(meta.uri), **kw).transform(
        JDF({"image": col(), "k": np.arange(4)}))
    got = ImageFeaturizer(model=PF.load(meta.uri), device="cpu", **kw) \
        .transform(PDF({"image": col(), "k": np.arange(4)}))
    assert got.columns == ref.columns and got.num_rows == 3
    np.testing.assert_array_equal(got["k"], ref["k"])
    assert err(got["f"], ref["f"]) <= RESIZED_TOL


def test_image_featurizer_round_trip_and_scorer_cache(zoo, tmp_path):
    meta = zoo["digits_resnet8"]
    x = np.random.default_rng(2).uniform(0, 1, (3, 8, 8, 1)).astype(
        np.float32)
    feat = ImageFeaturizer(model=PF.load(meta.uri), input_col="image",
                           device="cpu")
    first = feat.transform(PDF({"image": x}))["features"]
    assert feat._scorer is feat._scorer
    feat.save(str(tmp_path / "f"))
    assert os.path.isdir(str(tmp_path / "f" / "nnfunction"))
    back = PipelineStage.load(str(tmp_path / "f"), device="cpu")
    assert isinstance(back, ImageFeaturizer) and back.device == "cpu"
    np.testing.assert_array_equal(
        back.transform(PDF({"image": x}))["features"], first)
    feat.cut_output_layers = 2          # a param change drops the scorer
    assert feat.transform(PDF({"image": x}))["features"].shape[1] != \
        first.shape[1]


# -- persistence of the feature stages ----------------------------------------

def test_feature_stages_round_trip(tmp_path):
    cols = _mixed()
    df = _with_meta(PDF, cols)
    fitted = [
        PFA.Featurize(feature_columns=["num", "color", "text", "vec",
                                       "when"], output_col="f",
                      number_of_features=8).fit(df),
        PTX.TextFeaturizer(input_col="text", output_col="f",
                           use_n_gram=True).fit(df),
        PTX.IDF(input_col="vec", output_col="f").fit(df),
        PTX.Word2Vec(input_col="toks", output_col="f", vector_size=4,
                     device="cpu").fit(df.with_column(
                         "toks", [t.split() for t in cols["text"]])),
        PFA.VectorAssembler(input_cols=["num", "vec"], output_col="f"),
        PTX.Tokenizer(input_col="text", output_col="f"),
        PTX.PageSplitter(input_col="text", output_col="f",
                         maximum_page_length=10, minimum_page_length=5),
    ]
    work = df.with_column("toks", [t.split() for t in cols["text"]])
    for i, stage in enumerate(fitted):
        path = str(tmp_path / f"s{i}")
        stage.save(path)
        back = PipelineStage.load(path, device="cpu")
        assert type(back) is type(stage)
        a, b = back.transform(work)["f"], stage.transform(work)["f"]
        if a.dtype == np.dtype("O"):
            assert list(map(list, a)) == list(map(list, b))
        else:
            np.testing.assert_array_equal(a, b)
