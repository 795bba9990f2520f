"""The port's pipeline stages (``mmlspark_tpu_torch/stages/basic.py``,
``prep.py``, ``batching.py``) against the JAX package's, on the CPU.

The stages are host numpy in both packages, so every output is held
equal to JAX's on the same inputs: columns, dtypes, values and
metadata. The classes of ``tests/test_stages.py`` are mirrored on the
port, and the batchers of ``tests/test_image.py`` and
``tests/test_serving_pipeline.py``: ``TimeIntervalBatcher`` reads a
patched clock, and ``DynamicBufferedBatcher``'s producer thread is
gated wave by wave, so no test reads wall time or races a thread.
"""

import threading

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.stages import basic as JB
from mmlspark_tpu.stages import batching as JBT
from mmlspark_tpu.stages import prep as JP
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.parallel.sharding import bucket_target
from mmlspark_tpu_torch.stages import basic as PB
from mmlspark_tpu_torch.stages import batching as PBT
from mmlspark_tpu_torch.stages import prep as PP
from mmlspark_tpu_torch.stages import (
    DropColumns, SelectColumns, RenameColumn, Repartition, Cacher,
    CheckpointData, Explode, Lambda, UDFTransformer, TextPreprocessor,
    UnicodeNormalize, ClassBalancer, PartitionSample, MultiColumnAdapter,
    EnsembleByKey, SummarizeData,
    ValueIndexer, IndexToValue, CleanMissingData, DataConversion,
    BucketBatcher, FixedBatcher, DynamicBufferedBatcher, TimeIntervalBatcher,
    FixedMiniBatchTransformer, DynamicMiniBatchTransformer, FlattenBatch,
)

torch.set_num_threads(1)


def _basic(frame=DataFrame):
    return frame({
        "numbers": np.array([0, 1, 2, 3], dtype=np.int64),
        "doubles": np.array([0.0, 1.5, 2.5, 3.5]),
        "words": ["guitars", "drums", "bass", "keys"],
    })


@pytest.fixture
def basic_df():
    """The port's frame of ``conftest.basic_df``."""
    return _basic()


def _cell(v):
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, _cell(v.tolist()))
    if isinstance(v, (list, tuple)):
        return [_cell(x) for x in v]
    if isinstance(v, float) and v != v:
        return "nan"
    return v


def same_frames(got, ref):
    """Equal frames across the packages: columns, dtypes, values (NaN
    equal to NaN) and metadata."""
    assert got.columns == ref.columns
    assert got.num_rows == ref.num_rows
    for name in ref.columns:
        a, b = got[name], ref[name]
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if a.dtype == np.dtype("O"):
            assert [_cell(x) for x in a] == [_cell(x) for x in b], name
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.get_metadata(name) == ref.get_metadata(name), name


# -- tests/test_stages.py, on the port ---------------------------------------

class TestBasicStages:
    def test_drop_select_rename(self, basic_df):
        assert DropColumns(cols=["words"]).transform(basic_df).columns == \
            ["numbers", "doubles"]
        assert SelectColumns(cols=["words"]).transform(basic_df).columns == \
            ["words"]
        out = RenameColumn(input_col="words",
                           output_col="w").transform(basic_df)
        assert "w" in out.columns and "words" not in out.columns

    def test_repartition_disperse_preserves_rows(self, basic_df):
        out = Repartition(n=2, disperse=True).transform(basic_df)
        assert sorted(out["numbers"].tolist()) == [0, 1, 2, 3]

    def test_cacher_identity(self, basic_df):
        out = Cacher().transform(basic_df)
        np.testing.assert_array_equal(out["doubles"], basic_df["doubles"])

    def test_checkpoint_roundtrip(self, basic_df, tmp_path):
        out = CheckpointData(path=str(tmp_path / "ckpt")).transform(basic_df)
        assert out.num_rows == 4
        assert list(out["words"]) == list(basic_df["words"])

    def test_explode(self):
        df = DataFrame({"id": [1, 2], "vals": np.array([[1, 2, 3], [4]],
                                                       dtype=object)})
        out = Explode(input_col="vals", output_col="v").transform(df)
        assert out.num_rows == 4
        assert out["id"].tolist() == [1, 1, 1, 2]
        assert out["v"].tolist() == [1, 2, 3, 4]

    def test_lambda_and_udf(self, basic_df):
        out = Lambda(transform_fn=lambda d: d.head(2)).transform(basic_df)
        assert out.num_rows == 2
        out = UDFTransformer(input_col="numbers", output_col="sq",
                             udf=lambda v: v * v).transform(basic_df)
        assert out["sq"].tolist() == [0, 1, 4, 9]
        out = UDFTransformer(input_cols=["numbers", "doubles"],
                             output_col="s",
                             udf=lambda a, b: a + b,
                             vectorized=True).transform(basic_df)
        np.testing.assert_allclose(out["s"], [0.0, 2.5, 4.5, 6.5])

    def test_text_preprocessor_longest_match(self):
        df = DataFrame({"text": ["The happy sad person"]})
        out = TextPreprocessor(
            input_col="text", output_col="o",
            map={"happy": "sad", "happy sad": "sad sad"},
        ).transform(df)
        assert out["o"][0] == "The sad sad person"

    def test_unicode_normalize(self):
        df = DataFrame({"text": ["Ça Va Bien"]})
        out = UnicodeNormalize(input_col="text", output_col="o",
                               form="NFKD").transform(df)
        assert "ç" not in out["o"][0] or out["o"][0].islower()

    def test_class_balancer(self):
        df = DataFrame({"label": ["a", "a", "a", "b"]})
        model = ClassBalancer(input_col="label", output_col="w").fit(df)
        out = model.transform(df)
        np.testing.assert_allclose(out["w"], [1.0, 1.0, 1.0, 3.0])

    def test_partition_sample(self, basic_df):
        assert PartitionSample(mode="head", count=2).transform(basic_df) \
            .num_rows == 2
        out = PartitionSample(mode="assignToPartition",
                              num_parts=2).transform(basic_df)
        assert set(out["Partition"]) <= {0, 1}

    def test_multi_column_adapter(self):
        df = DataFrame({"a": ["X Y", "Z"], "b": ["Q", "R S"]})
        adapter = MultiColumnAdapter(
            base_stage=UnicodeNormalize(),
            input_cols=["a", "b"], output_cols=["a2", "b2"])
        out = adapter.transform(df)
        assert out["a2"].tolist() == ["x y", "z"]
        assert out["b2"].tolist() == ["q", "r s"]

    def test_ensemble_by_key(self):
        df = DataFrame({
            "key": ["u1", "u1", "u2"],
            "score": np.array([1.0, 3.0, 5.0]),
            "vec": np.array([[1.0, 0.0], [3.0, 2.0], [5.0, 4.0]]),
        })
        out = EnsembleByKey(keys=["key"], cols=["score", "vec"]).transform(df)
        assert out.num_rows == 2
        i1 = out["key"].tolist().index("u1")
        assert out["score_mean"][i1] == 2.0
        np.testing.assert_allclose(out["vec_mean"][i1], [2.0, 1.0])
        out2 = EnsembleByKey(keys=["key"], cols=["score"],
                             collapse_group=False).transform(df)
        assert out2.num_rows == 3
        assert out2["score_mean"].tolist() == [2.0, 2.0, 5.0]

    def test_summarize_data(self, basic_df):
        out = SummarizeData().transform(basic_df)
        assert out.num_rows == 3
        row = {r["Feature"]: r for r in out.rows()}
        assert row["doubles"]["Count"] == 4.0
        np.testing.assert_allclose(row["doubles"]["Mean"], 1.875)
        assert row["doubles"]["P50"] == 2.0


class TestValueIndexer:
    def test_roundtrip(self):
        df = DataFrame({"col": ["b", "a", "c", "a"]})
        model = ValueIndexer(input_col="col", output_col="idx").fit(df)
        out = model.transform(df)
        assert out["idx"].tolist() == [1, 0, 2, 0]
        back = IndexToValue(input_col="idx", output_col="orig").transform(out)
        assert back["orig"].tolist() == ["b", "a", "c", "a"]

    def test_null_ordering(self):
        df = DataFrame({"col": np.array(["b", None, "a"], dtype=object)})
        model = ValueIndexer(input_col="col", output_col="idx",
                             null_ordering="nullsFirst").fit(df)
        assert model.levels == [None, "a", "b"]
        assert model.transform(df)["idx"].tolist() == [2, 0, 1]
        model = ValueIndexer(input_col="col", output_col="idx",
                             null_ordering="nullsLast").fit(df)
        assert model.levels == ["a", "b", None]

    def test_numeric_levels(self):
        df = DataFrame({"col": np.array([10, -1, 10, 5])})
        model = ValueIndexer(input_col="col", output_col="idx").fit(df)
        assert model.levels == [-1, 5, 10]
        assert model.transform(df)["idx"].tolist() == [2, 0, 2, 1]

    def test_unseen_value_raises(self):
        df = DataFrame({"col": ["a"]})
        model = ValueIndexer(input_col="col", output_col="idx").fit(df)
        with pytest.raises(ValueError, match="unseen"):
            model.transform(DataFrame({"col": ["zz"]}))

    def test_save_load(self, tmp_path):
        df = DataFrame({"col": ["b", "a"]})
        model = ValueIndexer(input_col="col", output_col="idx").fit(df)
        model.save(str(tmp_path / "vi"))
        loaded = PipelineStage.load(str(tmp_path / "vi"))
        assert loaded.transform(df)["idx"].tolist() == [1, 0]


class TestCleanMissingData:
    def test_mean_median_custom(self):
        df = DataFrame({"a": np.array([1.0, np.nan, 3.0]),
                        "b": np.array([np.nan, 2.0, 4.0])})
        out = CleanMissingData(input_cols=["a", "b"],
                               cleaning_mode="Mean").fit(df).transform(df)
        np.testing.assert_allclose(out["a"], [1.0, 2.0, 3.0])
        np.testing.assert_allclose(out["b"], [3.0, 2.0, 4.0])
        out = CleanMissingData(input_cols=["a"], cleaning_mode="Median") \
            .fit(df).transform(df)
        np.testing.assert_allclose(out["a"], [1.0, 2.0, 3.0])
        out = CleanMissingData(input_cols=["a"], cleaning_mode="Custom",
                               custom_value=-9).fit(df).transform(df)
        np.testing.assert_allclose(out["a"], [1.0, -9.0, 3.0])

    def test_output_cols(self):
        df = DataFrame({"a": np.array([1.0, np.nan])})
        out = CleanMissingData(input_cols=["a"], output_cols=["a2"],
                               cleaning_mode="Mean").fit(df).transform(df)
        assert np.isnan(df["a"][1])
        np.testing.assert_allclose(out["a2"], [1.0, 1.0])


class TestDataConversion:
    def test_numeric_conversions(self):
        df = DataFrame({"x": np.array([1.7, 2.2])})
        assert DataConversion(cols=["x"], convert_to="integer") \
            .transform(df)["x"].dtype == np.int32
        assert DataConversion(cols=["x"], convert_to="long") \
            .transform(df)["x"].dtype == np.int64
        df2 = DataFrame({"s": ["1", "2"]})
        out = DataConversion(cols=["s"], convert_to="double").transform(df2)
        np.testing.assert_allclose(out["s"], [1.0, 2.0])

    def test_boolean_from_string(self):
        df = DataFrame({"s": ["true", "no"]})
        out = DataConversion(cols=["s"], convert_to="boolean").transform(df)
        assert out["s"].tolist() == [True, False]

    def test_date_roundtrip(self):
        fmt = "%Y-%m-%d %H:%M:%S"
        df = DataFrame({"d": ["2017-01-02 03:04:05"]})
        epoch = DataConversion(cols=["d"], convert_to="date",
                               date_time_format=fmt).transform(df)
        assert epoch["d"].dtype == np.int64
        back = DataConversion(cols=["d"], convert_to="date",
                              date_time_format=fmt).transform(epoch)
        assert back["d"][0] == "2017-01-02 03:04:05"

    def test_to_categorical_and_clear(self):
        df = DataFrame({"c": ["x", "y", "x"]})
        cat = DataConversion(cols=["c"], convert_to="toCategorical") \
            .transform(df)
        assert cat["c"].tolist() == [0, 1, 0]
        assert S.is_categorical(cat.get_metadata("c"))
        back = DataConversion(cols=["c"], convert_to="clearCategorical") \
            .transform(cat)
        assert back["c"].tolist() == ["x", "y", "x"]


class TestDataFramePersistence:
    def test_save_load(self, basic_df, tmp_path):
        p = str(tmp_path / "frame")
        basic_df.save(p)
        out = DataFrame.load(p)
        assert out.columns == basic_df.columns
        assert list(out["words"]) == list(basic_df["words"])
        np.testing.assert_allclose(out["doubles"], basic_df["doubles"])


# -- the batchers (tests/test_image.py, tests/test_serving_pipeline.py) ------

class _Clock:
    """A ``time`` stand-in whose monotonic clock moves only when told."""

    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


def _gated_waves(waves):
    """A source that yields ``waves`` one after another and, once every
    item of a wave has been handed over (the producer asks for the next
    one), sets that wave's ``queued`` event and waits for its ``gate``."""
    queued = [threading.Event() for _ in waves]
    gates = [threading.Event() for _ in waves]

    def source():
        for k, wave in enumerate(waves):
            yield from wave
            queued[k].set()
            if k + 1 < len(waves):
                assert gates[k].wait(30), "the test never opened the gate"
    return source, queued, gates


class TestBatching:
    def test_fixed_batcher(self):
        assert list(FixedBatcher(3)(range(7))) == [[0, 1, 2], [3, 4, 5], [6]]

    def test_dynamic_buffered_batcher(self):
        batches = list(DynamicBufferedBatcher()(range(100)))
        flat = [x for b in batches for x in b]
        assert flat == list(range(100))
        assert all(batches)

    def test_dynamic_batcher_takes_what_is_ready(self):
        """Each batch is exactly the wave the producer thread had queued
        when the consumer asked: the thread is gated, not raced. The
        first wave is one item (the consumer wakes on the first item the
        thread queues)."""
        waves = [[0], [1, 2, 3], [4], [5, 6, 7, 8, 9]]
        source, queued, gates = _gated_waves(waves)
        it = DynamicBufferedBatcher(max_buffer_size=16)(source())
        got = [next(it)]
        for k in range(1, len(waves)):
            gates[k - 1].set()
            assert queued[k].wait(30)
            got.append(next(it))
        assert list(it) == []
        assert got == waves

    def test_dynamic_batcher_propagates_errors(self):
        def gen():
            yield 1
            raise RuntimeError("boom")
        with pytest.raises(RuntimeError):
            list(DynamicBufferedBatcher()(gen()))

    def test_time_interval_batcher(self, monkeypatch):
        batches = list(TimeIntervalBatcher(interval=0.0,
                                           max_batch_size=2)(range(5)))
        flat = [x for b in batches for x in b]
        assert flat == list(range(5))
        # on a patched clock: a batch closes with the first item that
        # arrives at or past its deadline, as JAX's does on the same clock
        for module in (PBT, JBT):
            clock = _Clock()
            monkeypatch.setattr(module, "time", clock)

            def ticking():
                for i in range(7):
                    yield i
                    clock.now += 0.4        # 0.4 s between items
            got = list(module.TimeIntervalBatcher(interval=1.0)(ticking()))
            assert got == [[0, 1, 2, 3], [4, 5, 6]], module.__name__

    def test_minibatch_flatten_roundtrip(self, basic_df):
        batched = FixedMiniBatchTransformer(batch_size=3).transform(basic_df)
        assert batched.num_rows == 2
        assert len(batched["numbers"][0]) == 3
        flat = FlattenBatch().transform(batched)
        assert flat.num_rows == 4
        np.testing.assert_array_equal(
            np.asarray(flat["numbers"], dtype=np.int64), basic_df["numbers"])

    def test_dynamic_minibatch(self, basic_df):
        out = DynamicMiniBatchTransformer().transform(basic_df)
        assert out.num_rows == 1
        assert len(out["numbers"][0]) == 4


class TestBucketBatcher:
    def test_ladder(self):
        sizes = [len(b) for b in BucketBatcher(cap=8)(range(30))]
        assert sizes == [1, 2, 4, 8, 8, 7]

    def test_matches_bucket_targets(self):
        batches = list(BucketBatcher(cap=16)(range(100)))
        for batch in batches[:-1]:
            assert len(batch) == bucket_target(len(batch), 16)

    @pytest.mark.parametrize("cap", [1, 3, 8, 100])
    def test_ladder_matches_jax(self, cap):
        """The port's ladder is JAX's (``parallel/sharding.bucket_target``
        in both packages)."""
        assert [len(b) for b in BucketBatcher(cap=cap)(range(250))] == \
            [len(b) for b in JBT.BucketBatcher(cap=cap)(range(250))]


# -- parity with the JAX stages on the same inputs ---------------------------

def _tabular(frame, n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    x[rng.random(n) < 0.2, 1] = np.nan
    cat = rng.choice(["r", "g", "b"], size=n).tolist()
    cat[3] = None
    return frame({
        "a": x[:, 0], "b": x[:, 1], "c": x[:, 2],
        "k": rng.integers(0, 4, n).astype(np.int64),
        "cat": np.array(cat, dtype=object),
        "label": rng.choice(["yes", "no", "maybe"], size=n).tolist(),
        "text": [f"Ça {w} the happy sad {w}" for w in
                 rng.choice(["fox", "DOG", "Éclair"], size=n)],
        "vec": rng.normal(size=(n, 2)),
        "lists": np.array([list(range(i % 3 + 1)) for i in range(n)],
                          dtype=object),
    })


#: (name, stage factory given the module set, transformer or estimator)
PARITY = [
    ("drop", lambda B, P: B.DropColumns(cols=["a", "text"])),
    ("select", lambda B, P: B.SelectColumns(cols=["c", "label"])),
    ("rename", lambda B, P: B.RenameColumn(input_col="a", output_col="z")),
    ("scale", lambda B, P: B.ScaleColumn(input_col="c", output_col="s",
                                         scale=2.5, offset=-1.0)),
    ("repartition", lambda B, P: B.Repartition(n=3, disperse=True)),
    ("cacher", lambda B, P: B.Cacher()),
    ("explode", lambda B, P: B.Explode(input_col="lists", output_col="e")),
    ("text", lambda B, P: B.TextPreprocessor(
        input_col="text", output_col="o", norm_func="lowercase",
        map={"happy": "glad", "happy sad": "mixed", "the": "a"})),
    ("unicode_nfkd", lambda B, P: B.UnicodeNormalize(input_col="text",
                                                     output_col="o")),
    ("unicode_nfc", lambda B, P: B.UnicodeNormalize(
        input_col="text", output_col="o", form="NFC", lower=False)),
    ("balancer", lambda B, P: B.ClassBalancer(input_col="label",
                                              output_col="w")),
    ("balancer_int", lambda B, P: B.ClassBalancer(input_col="k")),
    ("sample_head", lambda B, P: B.PartitionSample(mode="head", count=7)),
    ("sample_random", lambda B, P: B.PartitionSample(percent=0.3, seed=5)),
    ("sample_assign", lambda B, P: B.PartitionSample(
        mode="assignToPartition", num_parts=4, seed=2)),
    ("adapter", lambda B, P: B.MultiColumnAdapter(
        base_stage=B.UnicodeNormalize(), input_cols=["text", "label"],
        output_cols=["t2", "l2"])),
    ("ensemble", lambda B, P: B.EnsembleByKey(keys=["k"],
                                              cols=["a", "vec", "label"])),
    ("ensemble_broadcast", lambda B, P: B.EnsembleByKey(
        keys=["label", "k"], cols=["c"], collapse_group=False)),
    ("summarize", lambda B, P: B.SummarizeData()),
    ("summarize_counts", lambda B, P: B.SummarizeData(basic=False,
                                                      percentiles=False)),
    ("indexer_str", lambda B, P: P.ValueIndexer(input_col="cat",
                                                output_col="ci")),
    ("indexer_last", lambda B, P: P.ValueIndexer(
        input_col="cat", output_col="ci", null_ordering="nullsLast")),
    ("indexer_int", lambda B, P: P.ValueIndexer(input_col="k")),
    ("clean_mean", lambda B, P: P.CleanMissingData(input_cols=["a", "b"])),
    ("clean_median", lambda B, P: P.CleanMissingData(
        input_cols=["b"], output_cols=["b2"], cleaning_mode="Median")),
    ("convert_int", lambda B, P: P.DataConversion(cols=["a", "c"],
                                                  convert_to="integer")),
    ("convert_float", lambda B, P: P.DataConversion(cols=["k"],
                                                    convert_to="float")),
    ("convert_string", lambda B, P: P.DataConversion(
        cols=["a", "k", "cat"], convert_to="string")),
    ("to_categorical", lambda B, P: P.DataConversion(
        cols=["label"], convert_to="toCategorical")),
]


@pytest.mark.parametrize("name,make", PARITY, ids=[p[0] for p in PARITY])
def test_stage_matches_jax(name, make):
    jdf, pdf = _tabular(JDF), _tabular(DataFrame)
    jstage, pstage = make(JB, JP), make(PB, PP)
    if hasattr(pstage, "fit"):
        jstage, pstage = jstage.fit(jdf), pstage.fit(pdf)
        assert pstage._json_params() == jstage._json_params()
    same_frames(pstage.transform(pdf), jstage.transform(jdf))


def test_prep_chain_matches_jax():
    """Indexing, imputation, conversion and back, chained in both."""
    def chain(B, P, frame):
        df = _tabular(frame, n=64, seed=3)
        df = P.CleanMissingData(input_cols=["b"]).fit(df).transform(df)
        df = P.ValueIndexer(input_col="cat", output_col="ci").fit(df) \
            .transform(df)
        df = P.IndexToValue(input_col="ci", output_col="back").transform(df)
        df = P.DataConversion(cols=["ci"], convert_to="clearCategorical") \
            .transform(df)
        df = P.DataConversion(cols=["k"], convert_to="double").transform(df)
        df = B.ClassBalancer(input_col="label").fit(df).transform(df)
        return df, B.SummarizeData().transform(df)
    pdf, psum = chain(PB, PP, DataFrame)
    jdf, jsum = chain(JB, JP, JDF)
    same_frames(pdf, jdf)
    same_frames(psum, jsum)


def test_dates_match_jax():
    fmt = "%d/%m/%Y %H:%M"
    cols = {"d": np.array(["01/02/2003 04:05", None, "31/12/1999 23:59"],
                          dtype=object),
            "e": np.array([0, 86400 * 365, 1.5e9], dtype=np.float64)}
    for convert in ({"cols": ["d"]}, {"cols": ["e"]}):
        p = PP.DataConversion(convert_to="date", date_time_format=fmt,
                              **convert).transform(DataFrame(dict(cols)))
        j = JP.DataConversion(convert_to="date", date_time_format=fmt,
                              **convert).transform(JDF(dict(cols)))
        same_frames(p, j)


def test_minibatches_match_jax():
    for make in (lambda M: M.FixedMiniBatchTransformer(batch_size=7),
                 lambda M: M.DynamicMiniBatchTransformer(max_batch_size=9)):
        p = make(PBT).transform(_tabular(DataFrame))
        j = make(JBT).transform(_tabular(JDF))
        same_frames(p, j)
        same_frames(PBT.FlattenBatch().transform(p),
                    JBT.FlattenBatch().transform(j))


def test_checkpoint_data_goes_through_the_ports_frame_files(tmp_path):
    """``CheckpointData`` writes with the port's ``DataFrame.save`` and
    reads back with its ``load``; JAX's ``DataFrame.load`` reads the
    port's checkpoint (the same files)."""
    df = _tabular(DataFrame).drop("lists")
    out = CheckpointData(path=str(tmp_path / "c")).transform(df)
    same_frames(out, df)
    same_frames(JDF.load(str(tmp_path / "c" / "frame.npz")), out)
    CheckpointData(path=str(tmp_path / "r"),
                   remove_checkpoint=True).transform(df)
    assert not (tmp_path / "r" / "frame.npz").exists()


def test_timer_is_the_ports_core_stage():
    from mmlspark_tpu_torch.core import stage as CS
    assert PB.Timer is CS.Timer and PB.TimerModel is CS.TimerModel
