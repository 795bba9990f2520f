"""The port's counterpart of ``tests/test_fuzzing.py``: a sweep over every
public stage the port registers (``core/registry.all_stages``, which
imports ``STAGE_MODULES``).

Every stage gets an *experiment* run (fit/transform executes), a
*serialization* round-trip (save/load the stage, the fitted model, and
a pipeline wrapping it; outputs must match), a *determinism* check (two
runs agree) and a param get/set round-trip. Stages that take a device
run on ``device="cpu"``, and every load places its tree there
(``load_stage(path, device="cpu")``); ``device`` itself is never
persisted. Network stages (the HTTP stages and the services) are only
constructed and persisted, as in ``tests/test_fuzzing.py``: their cases
run no experiment. ``test_every_stage_has_fuzzing_objects`` holds the registry
to the three tables: each public stage is fuzzed, covered by the
estimator that makes it, or exempt as an abstract base. A stage whose
state cannot be saved (a Python function, a scratch path) is left out of
the serialization sweep by name, not skipped.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from typing import Callable

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel
from mmlspark_tpu_torch.core.registry import STAGE_MODULES, all_stages
from mmlspark_tpu_torch.core.serialize import _jsonify, load_stage, save_stage
from mmlspark_tpu_torch.core.stage import (
    Estimator, Evaluator, PipelineStage, Transformer,
)

torch.set_num_threads(1)


def _val_eq(a, b, rtol=1e-5, atol=1e-6) -> bool:
    """Deep equality tolerant of nested arrays/dicts/lists in object cells."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(_val_eq(a[k], b[k], rtol, atol) for k in a))
    if isinstance(a, (list, tuple, np.ndarray)) or \
            isinstance(b, (list, tuple, np.ndarray)):
        aa, bb = np.asarray(a), np.asarray(b)
        if aa.shape != bb.shape:
            return False
        if aa.dtype == np.dtype("O") or bb.dtype == np.dtype("O"):
            return all(_val_eq(x, y, rtol, atol)
                       for x, y in zip(aa.ravel(), bb.ravel()))
        if aa.dtype.kind in "if" and bb.dtype.kind in "if":
            return bool(np.allclose(aa, bb, rtol=rtol, atol=atol,
                                    equal_nan=True))
        return bool((aa == bb).all())
    if isinstance(a, float) and isinstance(b, float):
        return bool(np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True))
    return a == b


def assert_df_eq(a, b, rtol=1e-5, atol=1e-6):
    assert a.columns == b.columns, f"{a.columns} != {b.columns}"
    assert a.num_rows == b.num_rows
    for name in a.columns:
        assert _val_eq(a[name], b[name], rtol, atol), f"column {name} differs"


# -- input frames --------------------------------------------------------------

def _basic_df():
    return DataFrame({
        "numbers": np.array([0, 1, 2, 3], dtype=np.int64),
        "doubles": np.array([0.0, 1.5, 2.5, 3.5]),
        "words": ["guitars", "drums", "bass", "keys"],
    })


def _text_df():
    return DataFrame({"text": ["the quick brown fox", "jumps over the dog",
                               "pack my box", "five dozen jugs"]})


def _tabular_df(n=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float64)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    return DataFrame({"features": x, "label": y,
                      "a": x[:, 0], "b": x[:, 1], "c": x[:, 2]})


def _image_df(n=2, h=16, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return DataFrame({
        "image": rng.uniform(0, 255, size=(n, h, w, 3)).astype(np.float32)})


def _events_df(seed=0):
    rng = np.random.default_rng(seed)
    n = 64
    return DataFrame({
        "user": [f"u{int(i)}" for i in rng.integers(0, 6, n)],
        "item": [f"i{int(i)}" for i in rng.integers(0, 10, n)],
        "user_idx": rng.integers(0, 6, n).astype(np.int64),
        "item_idx": rng.integers(0, 10, n).astype(np.int64),
        "rating": rng.integers(1, 6, n).astype(np.float64),
    })


def _scored_df():
    df = _tabular_df()
    p = 1.0 / (1.0 + np.exp(-(np.asarray(df["a"]) + np.asarray(df["b"]))))
    return (df.with_column("prediction", (p > 0.5).astype(np.float64))
              .with_column("probability", np.stack([1 - p, p], axis=1))
              .with_column("raw_prediction", np.stack([-p, p], axis=1)))


# -- fuzzing objects -------------------------------------------------------------

@dataclasses.dataclass
class Case:
    make: Callable[[], object]          # () -> stage
    df: Callable[[], DataFrame]         # () -> input frame
    serialization: bool = True          # save/load round-trip
    deterministic: bool = True          # transform twice must agree
    experiment: bool = True             # run fit/transform


FUZZING_OBJECTS = {}
M = "mmlspark_tpu_torch."


def case(name, **kw):
    FUZZING_OBJECTS[M + name] = Case(**kw)


def _mk(path, /, **kw):
    """A factory for the port stage ``mmlspark_tpu_torch.<path>``, on the
    CPU when it takes a device."""
    mod, cls = (M + path).rsplit(".", 1)

    def f():
        klass = getattr(__import__(mod, fromlist=[cls]), cls)
        if "device" in klass.params():
            kw.setdefault("device", "cpu")
        return klass(**kw)
    return f


SMALL_GBDT = dict(num_iterations=8, num_leaves=7, min_data_in_leaf=5)


def _gbdt_cls():
    return _mk("gbdt.stages.GBDTClassifier", **SMALL_GBDT)()


def _gbdt_reg():
    return _mk("gbdt.stages.GBDTRegressor", **SMALL_GBDT)()


def _fn(arch, shape):
    from mmlspark_tpu_torch.models.function import NNFunction
    return NNFunction.init(arch, input_shape=shape, seed=0)


def _nn_model():
    return _mk("models.nn.NNModel", input_col="features", batch_size=32,
               model=_fn({"builder": "mlp", "hidden": [8],
                          "num_outputs": 2}, (3,)))()


def _sar():
    return _mk("recommend.sar.SAR", support_threshold=1)()


def _scale():
    return _mk("stages.basic.ScaleColumn", input_col="a", output_col="a2",
               scale=2.0)()


def _fitted_gbdt():
    return _gbdt_cls().fit(_tabular_df())


# ---- core --------------------------------------------------------------------
case("core.stage.Timer", make=_mk("core.stage.Timer", stage=_scale()),
     df=_tabular_df)
case("core.pipeline.Pipeline",
     make=lambda: Pipeline(stages=[_mk("stages.basic.DropColumns",
                                       cols=["c"])(), _scale()]),
     df=_tabular_df)

# ---- basic stages ------------------------------------------------------------
case("stages.basic.DropColumns", make=_mk("stages.basic.DropColumns",
     cols=["words"]), df=_basic_df)
case("stages.basic.SelectColumns", make=_mk("stages.basic.SelectColumns",
     cols=["words"]), df=_basic_df)
case("stages.basic.RenameColumn", make=_mk("stages.basic.RenameColumn",
     input_col="words", output_col="w"), df=_basic_df)
case("stages.basic.ScaleColumn", make=_mk("stages.basic.ScaleColumn",
     input_col="doubles", output_col="scaled", scale=2.0, offset=1.0),
     df=_basic_df)
case("stages.basic.Repartition", make=_mk("stages.basic.Repartition", n=2,
     disperse=True), df=_basic_df)
case("stages.basic.Cacher", make=_mk("stages.basic.Cacher"), df=_basic_df)
case("stages.basic.CheckpointData",
     make=lambda: _mk("stages.basic.CheckpointData",
                      path=tempfile.mkdtemp())(),
     df=_basic_df, serialization=False)     # a run-local scratch path
case("stages.basic.Explode", make=_mk("stages.basic.Explode",
     input_col="vals", output_col="v"),
     df=lambda: DataFrame({"vals": [[1, 2], [3]], "k": ["a", "b"]}))
case("stages.basic.Lambda", make=_mk("stages.basic.Lambda",
     transform_fn=lambda d: d.head(2)), df=_basic_df,
     serialization=False)                   # a Python function
case("stages.basic.UDFTransformer", make=_mk("stages.basic.UDFTransformer",
     input_col="numbers", output_col="sq", udf=lambda x: x * x),
     df=_basic_df, serialization=False)     # a Python function
case("stages.basic.TextPreprocessor", make=_mk(
     "stages.basic.TextPreprocessor", input_col="text", output_col="o",
     map={"quick": "slow"}), df=_text_df)
case("stages.basic.UnicodeNormalize", make=_mk(
     "stages.basic.UnicodeNormalize", input_col="text", output_col="o"),
     df=_text_df)
case("stages.basic.ClassBalancer", make=_mk("stages.basic.ClassBalancer",
     input_col="label", output_col="w"), df=_tabular_df)
case("stages.basic.PartitionSample", make=_mk(
     "stages.basic.PartitionSample", mode="head", count=2), df=_basic_df)
case("stages.basic.MultiColumnAdapter",
     make=lambda: _mk("stages.basic.MultiColumnAdapter",
                      base_stage=_mk("stages.basic.UnicodeNormalize")(),
                      input_cols=["text"], output_cols=["o"])(),
     df=_text_df)
case("stages.basic.EnsembleByKey", make=_mk("stages.basic.EnsembleByKey",
     keys=["k"], cols=["x"]),
     df=lambda: DataFrame({"k": ["a", "a", "b"],
                           "x": np.array([1.0, 2.0, 3.0])}))
case("stages.basic.SummarizeData", make=_mk("stages.basic.SummarizeData"),
     df=_basic_df)

# ---- prep --------------------------------------------------------------------
case("stages.prep.ValueIndexer", make=_mk("stages.prep.ValueIndexer",
     input_col="words", output_col="idx"), df=_basic_df)
case("stages.prep.IndexToValue", make=_mk("stages.prep.IndexToValue",
     input_col="cat", output_col="orig"),
     df=lambda: _mk("stages.prep.ValueIndexer", input_col="words",
                    output_col="cat")().fit(_basic_df())
     .transform(_basic_df()))
case("stages.prep.CleanMissingData", make=_mk(
     "stages.prep.CleanMissingData", input_cols=["a"]),
     df=lambda: DataFrame({"a": np.array([1.0, np.nan, 3.0, 4.0])}))
case("stages.prep.DataConversion", make=_mk("stages.prep.DataConversion",
     cols=["numbers"], convert_to="double"), df=_basic_df)

# ---- image / batching ----------------------------------------------------------
case("stages.image.ImageTransformer",
     make=lambda: _mk("stages.image.ImageTransformer")().resize(8, 8).flip(),
     df=_image_df)
case("stages.image.ResizeImageTransformer", make=_mk(
     "stages.image.ResizeImageTransformer", height=8, width=8), df=_image_df)
case("stages.image.UnrollImage", make=_mk("stages.image.UnrollImage"),
     df=_image_df)
case("stages.image.ImageSetAugmenter", make=_mk(
     "stages.image.ImageSetAugmenter"), df=_image_df)


def _png_df():
    from mmlspark_tpu_torch.io.images import encode_image
    rng = np.random.default_rng(0)
    cells = np.empty(3, dtype=object)
    cells[:] = [encode_image(rng.integers(0, 256, (h, 9, 3), dtype=np.uint8))
                for h in (9, 12, 9)]
    return DataFrame({"bytes": cells})


case("stages.image.UnrollBinaryImage", make=_mk(
     "stages.image.UnrollBinaryImage", height=8, width=8), df=_png_df)
case("stages.batching.FixedMiniBatchTransformer", make=_mk(
     "stages.batching.FixedMiniBatchTransformer", batch_size=3),
     df=_basic_df)
case("stages.batching.DynamicMiniBatchTransformer", make=_mk(
     "stages.batching.DynamicMiniBatchTransformer"), df=_basic_df)
case("stages.batching.FlattenBatch", make=_mk("stages.batching.FlattenBatch"),
     df=lambda: _mk("stages.batching.FixedMiniBatchTransformer",
                    batch_size=2)().transform(_basic_df()))

# ---- featurize -----------------------------------------------------------------
def _tokens():
    return _mk("featurize.text.Tokenizer", input_col="text",
               output_col="toks")().transform(_text_df())


case("featurize.assemble.VectorAssembler", make=_mk(
     "featurize.assemble.VectorAssembler", input_cols=["a", "b"],
     output_col="f"), df=_tabular_df)
case("featurize.assemble.Featurize", make=_mk("featurize.assemble.Featurize",
     feature_columns=["a", "b"], output_col="f"), df=_tabular_df)
case("featurize.text.Tokenizer", make=_mk("featurize.text.Tokenizer",
     input_col="text", output_col="toks"), df=_text_df)
case("featurize.text.StopWordsRemover", make=_mk(
     "featurize.text.StopWordsRemover", input_col="toks", output_col="ns"),
     df=_tokens)
case("featurize.text.NGram", make=_mk("featurize.text.NGram",
     input_col="toks", output_col="bi"), df=_tokens)
case("featurize.text.MultiNGram", make=_mk("featurize.text.MultiNGram",
     input_col="toks", output_col="g", lengths=[1, 2]), df=_tokens)
case("featurize.text.HashingTF", make=_mk("featurize.text.HashingTF",
     input_col="toks", output_col="tf", num_features=16), df=_tokens)
case("featurize.text.IDF", make=_mk("featurize.text.IDF", input_col="tf",
     output_col="tfidf"),
     df=lambda: _mk("featurize.text.HashingTF", input_col="toks",
                    output_col="tf", num_features=16)().transform(_tokens()))
case("featurize.text.TextFeaturizer", make=_mk(
     "featurize.text.TextFeaturizer", input_col="text", output_col="f",
     num_features=16), df=_text_df)
case("featurize.text.Word2Vec", make=_mk("featurize.text.Word2Vec",
     input_col="toks", output_col="vec", vector_size=4, max_iter=2),
     df=_tokens)
case("featurize.text.PageSplitter", make=_mk("featurize.text.PageSplitter",
     input_col="text", output_col="pages", maximum_page_length=10,
     minimum_page_length=5), df=_text_df)

# ---- gbdt / nn / automl ----------------------------------------------------------
case("gbdt.stages.GBDTClassifier", make=_gbdt_cls, df=_tabular_df)
case("gbdt.stages.GBDTRegressor", make=_gbdt_reg,
     df=lambda: DataFrame({"features": np.random.default_rng(0)
                           .normal(size=(96, 3)),
                           "label": np.random.default_rng(1)
                           .normal(size=96)}))
case("models.trainer.NNLearner", make=_mk(
     "models.trainer.NNLearner",
     arch={"builder": "mlp", "hidden": [8], "num_outputs": 2}, epochs=1,
     batch_size=32, log_every=0), df=_tabular_df)
case("models.nn.NNModel", make=_nn_model, df=_tabular_df)
case("models.featurizer.ImageFeaturizer",
     make=lambda: _mk("models.featurizer.ImageFeaturizer",
                      model=_fn({"builder": "cifar_convnet"}, (16, 16, 3)),
                      cut_output_layers=1, batch_size=8)(),
     df=_image_df)
case("automl.train.TrainClassifier",
     make=lambda: _mk("automl.train.TrainClassifier", model=_gbdt_cls(),
                      label_col="label")(), df=_tabular_df)
case("automl.train.TrainRegressor",
     make=lambda: _mk("automl.train.TrainRegressor", model=_gbdt_reg(),
                      label_col="c")(), df=_tabular_df)
case("automl.metrics.ComputeModelStatistics", make=_mk(
     "automl.metrics.ComputeModelStatistics", label_col="label",
     scored_labels_col="prediction", scored_probabilities_col="probability"),
     df=_scored_df)
case("automl.metrics.ComputePerInstanceStatistics", make=_mk(
     "automl.metrics.ComputePerInstanceStatistics", label_col="label"),
     df=_scored_df)
case("automl.best.FindBestModel",
     make=lambda: _mk("automl.best.FindBestModel", label_col="label",
                      evaluation_metric="accuracy", models=[
                          _mk("automl.train.TrainClassifier",
                              model=_gbdt_cls(), label_col="label")()
                          .fit(_tabular_df())])(),
     df=_tabular_df)
case("automl.tune.TuneHyperparameters",
     make=lambda: _mk(
         "automl.tune.TuneHyperparameters",
         models=[_mk("automl.train.TrainClassifier", model=_gbdt_cls(),
                     label_col="label")()],
         param_space={"num_leaves": __import__(
             M + "automl.tune", fromlist=["DiscreteHyperParam"])
             .DiscreteHyperParam([3, 7])},
         evaluation_metric="accuracy", num_folds=2, num_runs=2,
         parallelism=1, seed=3)(),
     df=_tabular_df)

# ---- recommend -------------------------------------------------------------------
case("recommend.indexer.RecommendationIndexer", make=_mk(
     "recommend.indexer.RecommendationIndexer", user_input_col="user",
     item_input_col="item"), df=_events_df)
case("recommend.sar.SAR", make=_sar, df=_events_df)
case("recommend.ranking.RankingAdapter",
     make=lambda: _mk("recommend.ranking.RankingAdapter", recommender=_sar(),
                      k=3)(), df=_events_df)
case("recommend.ranking.RankingEvaluator", make=_mk(
     "recommend.ranking.RankingEvaluator", k=2),
     df=lambda: DataFrame({"recommendations": [[1, 2], [3, 4]],
                           "labels": [[1], [4]]}))
case("recommend.ranking.RankingTrainValidationSplit",
     make=lambda: _mk(
         "recommend.ranking.RankingTrainValidationSplit", estimator=_sar(),
         evaluator=_mk("recommend.ranking.RankingEvaluator", k=3)(),
         param_maps=[{"similarity_function": "jaccard"}])(),
     df=_events_df)

# ---- explain (the explained models are port stages, so they persist) -------
case("explain.superpixel.SuperpixelTransformer", make=_mk(
     "explain.superpixel.SuperpixelTransformer", cell_size=8), df=_image_df)
case("explain.lime.TabularLIME",
     make=lambda: _mk("explain.lime.TabularLIME", model=_fitted_gbdt(),
                      predict_col="probability", n_samples=32,
                      sample_batch=4)(),
     df=lambda: _tabular_df().head(8))
case("explain.lime.ImageLIME",
     make=lambda: _mk(
         "explain.lime.ImageLIME", predict_col="scores", n_samples=8,
         cell_size=8,
         model=_mk("models.nn.NNModel", input_col="image", batch_size=8,
                   model=_fn({"builder": "cifar_convnet"}, (16, 16, 3)))())(),
     df=_image_df)

# ---- serving ---------------------------------------------------------------------
case("serving.consolidator.PartitionConsolidator",
     make=_mk("serving.consolidator.PartitionConsolidator", stage=_scale(),
              group="fuzz"), df=_tabular_df)

# ---- http / services (network stages: construction + persistence only) ---
NOWHERE = "http://127.0.0.1:9/x"
case("io.http.HTTPTransformer", make=_mk("io.http.HTTPTransformer",
     concurrency=2), df=_basic_df, experiment=False)
case("io.http.SimpleHTTPTransformer",
     make=lambda: _mk("io.http.SimpleHTTPTransformer",
                      input_parser=_mk("io.http.JSONInputParser",
                                       url=NOWHERE)())(),
     df=_basic_df, experiment=False)
case("io.http.JSONInputParser", make=_mk("io.http.JSONInputParser",
     url=NOWHERE), df=lambda: DataFrame({"value": [{"q": 1}, {"q": 2}]}))
case("io.http.JSONOutputParser", make=_mk("io.http.JSONOutputParser"),
     df=_basic_df, experiment=False)
case("io.http.StringOutputParser", make=_mk("io.http.StringOutputParser"),
     df=_basic_df, experiment=False)
case("io.http.CustomInputParser", make=_mk("io.http.CustomInputParser",
     udf=lambda v: v), df=_basic_df, experiment=False,
     serialization=False)                   # a Python function
case("io.http.CustomOutputParser", make=_mk("io.http.CustomOutputParser",
     udf=lambda r: r), df=_basic_df, experiment=False,
     serialization=False)                   # a Python function
for _svc in ("TextSentiment", "LanguageDetector", "EntityDetector", "NER",
             "KeyPhraseExtractor", "AnalyzeImage", "OCR", "DescribeImage",
             "TagImage", "DetectAnomalies", "GenerateThumbnails",
             "RecognizeText", "RecognizeDomainSpecificContent", "DetectFace",
             "FindSimilarFace", "GroupFaces", "IdentifyFaces", "VerifyFaces",
             "SpeechToText", "BingImageSearch"):
    case("io.services." + _svc, make=_mk("io.services." + _svc,
         url=NOWHERE), df=_basic_df, experiment=False)

# Models produced (and therefore exercised) by fitting these estimators.
COVERED_BY_ESTIMATOR = {M + k: M + v for k, v in {
    "core.stage.TimerModel": "core.stage.Timer",
    "core.pipeline.PipelineModel": "core.pipeline.Pipeline",
    "stages.basic.ClassBalancerModel": "stages.basic.ClassBalancer",
    "stages.prep.ValueIndexerModel": "stages.prep.ValueIndexer",
    "stages.prep.CleanMissingDataModel": "stages.prep.CleanMissingData",
    "featurize.assemble.FeaturizeModel": "featurize.assemble.Featurize",
    "featurize.text.IDFModel": "featurize.text.IDF",
    "featurize.text.TextFeaturizerModel": "featurize.text.TextFeaturizer",
    "featurize.text.Word2VecModel": "featurize.text.Word2Vec",
    "gbdt.stages.GBDTClassificationModel": "gbdt.stages.GBDTClassifier",
    "gbdt.stages.GBDTRegressionModel": "gbdt.stages.GBDTRegressor",
    "automl.train.TrainedClassifierModel": "automl.train.TrainClassifier",
    "automl.train.TrainedRegressorModel": "automl.train.TrainRegressor",
    "automl.best.BestModel": "automl.best.FindBestModel",
    "automl.tune.TuneHyperparametersModel":
        "automl.tune.TuneHyperparameters",
    "recommend.indexer.RecommendationIndexerModel":
        "recommend.indexer.RecommendationIndexer",
    "recommend.ranking.RankingAdapterModel": "recommend.ranking.RankingAdapter",
    "recommend.ranking.RankingTrainValidationSplitModel":
        "recommend.ranking.RankingTrainValidationSplit",
    "recommend.sar.SARModel": "recommend.sar.SAR",
    "explain.lime.TabularLIMEModel": "explain.lime.TabularLIME",
    "explain.lime.ImageLIMEModel": "explain.lime.ImageLIME",
}.items()}

# Abstract bases that cannot be fuzzed standalone.
EXEMPT = {M + n for n in ("core.stage.Transformer", "core.stage.Estimator",
                          "core.stage.Model", "core.stage.Evaluator",
                          "explain.lime.LIMEBase",
                          "io.services.CognitiveServiceBase")}


# -- the sweep ---------------------------------------------------------------------

def test_every_stage_has_fuzzing_objects():
    """Parity: FuzzingTest.scala's reflection assertion, over the port."""
    registered = set(all_stages())
    missing = sorted(registered - set(FUZZING_OBJECTS)
                     - set(COVERED_BY_ESTIMATOR) - EXEMPT)
    assert not missing, f"stages without fuzzing objects: {missing}"
    stale = sorted((set(FUZZING_OBJECTS) | set(COVERED_BY_ESTIMATOR)
                    | EXEMPT) - registered)
    assert not stale, f"fuzzing objects of no registered stage: {stale}"


def test_the_new_stage_modules_are_registered():
    for module in ("automl.metrics", "automl.best", "automl.tune",
                   "stages.basic", "stages.prep", "stages.batching",
                   "recommend.indexer", "recommend.sar", "recommend.ranking",
                   "explain.superpixel", "explain.lime", "io.http",
                   "io.services"):
        assert M + module in STAGE_MODULES, module
        assert any(k.startswith(M + module + ".") for k in all_stages())


_IDS = sorted(FUZZING_OBJECTS)
_RUN = [n for n in _IDS if FUZZING_OBJECTS[n].experiment]
_SERIALIZED = [n for n in _IDS if FUZZING_OBJECTS[n].serialization]
_DETERMINISTIC = [n for n in _RUN if FUZZING_OBJECTS[n].deterministic]


def _run(stage, df):
    """fit/evaluate/transform as appropriate; return (artifact, output)."""
    if isinstance(stage, Estimator):
        model = stage.fit(df)
        return model, model.transform(df)
    if isinstance(stage, Evaluator):
        stage.evaluate(df)
        return stage, None
    return stage, stage.transform(df)


@pytest.mark.parametrize("name", _RUN)
def test_experiment(name):
    """Parity: ExperimentFuzzing — the stage runs end-to-end."""
    c = FUZZING_OBJECTS[name]
    _run(c.make(), c.df())


def _as_json(params):
    """Params as persistence writes them (tuples become lists)."""
    return json.loads(json.dumps(_jsonify(params)))


def _on_cpu(stage) -> bool:
    return "device" not in type(stage).params() or stage.device == "cpu"


@pytest.mark.parametrize("name", _SERIALIZED)
def test_serialization_roundtrip(name, tmp_path):
    """Parity: SerializationFuzzing — save/load stage, model, pipeline;
    the loader's device reaches every stage of the tree."""
    c = FUZZING_OBJECTS[name]
    stage, df = c.make(), c.df()
    save_stage(stage, str(tmp_path / "stage"))
    assert "\"device\"" not in (tmp_path / "stage" / "metadata.json") \
        .read_text()
    loaded = load_stage(str(tmp_path / "stage"), device="cpu")
    assert type(loaded) is type(stage)
    assert _as_json(loaded._json_params()) == _as_json(stage._json_params())
    assert _on_cpu(loaded)
    if not c.experiment:
        return
    fitted, out = _run(stage, df)
    save_stage(fitted, str(tmp_path / "fitted"))
    refit = load_stage(str(tmp_path / "fitted"), device="cpu")
    assert type(refit) is type(fitted) and _on_cpu(refit)
    if out is not None and c.deterministic:
        assert_df_eq(refit.transform(df), fitted.transform(df))
    if isinstance(fitted, Transformer):
        PipelineModel(stages=[fitted]).save(str(tmp_path / "pipe"))
        pl = PipelineStage.load(str(tmp_path / "pipe"), device="cpu")
        if out is not None and c.deterministic:
            assert_df_eq(pl.transform(df), out)


@pytest.mark.parametrize("name", _DETERMINISTIC)
def test_determinism(name):
    """Two identical runs produce identical outputs."""
    c = FUZZING_OBJECTS[name]
    _, out1 = _run(c.make(), c.df())
    _, out2 = _run(c.make(), c.df())
    if out1 is not None and out2 is not None:
        assert_df_eq(out1, out2)


@pytest.mark.parametrize("name", _IDS)
def test_param_get_set_roundtrip(name):
    """Every non-complex param survives get -> set -> get on its stage."""
    stage = FUZZING_OBJECTS[name].make()
    for pname, p in type(stage).params().items():
        if p.complex:
            continue
        value = getattr(stage, pname)
        setattr(stage, pname, value)
        got = getattr(stage, pname)
        if isinstance(value, np.ndarray):
            assert np.array_equal(got, value), pname
        else:
            assert got == value or (value != value and got != got), pname
