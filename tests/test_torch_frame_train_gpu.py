"""Frame training and features on the card, held against the port's
own CPU path on the same inputs.

Every test here is marked ``gpu`` and skips without a CUDA card; the
file imports nothing of JAX. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_frame_train_gpu.py

Tolerances, ``max |got - ref| <= tol x max(1, max |ref|)``: image ops
and stages 1e-5 (f32, TF32 off); ``NNLearner`` fits in f32 (the step
holds TF32 off) 1e-4 on every step's loss (relative) and on the
parameters, after a few steps of lr 0.01 in which cuDNN's and the CPU's
sums part by rounding only; ``ImageFeaturizer`` f32 1e-4; ``Word2Vec``
1e-5.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.automl import TrainClassifier
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.featurize.text import Word2Vec
from mmlspark_tpu_torch.gbdt import cuda_hist as CH
from mmlspark_tpu_torch.gbdt.stages import GBDTClassifier
from mmlspark_tpu_torch.models import ImageFeaturizer, NNFunction, NNLearner
from mmlspark_tpu_torch.models.function import flatten_params
from mmlspark_tpu_torch.stages import ImageTransformer

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _err(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def test_image_chain_on_the_card(dev):
    x = np.random.default_rng(0).uniform(0, 255, (6, 64, 64, 3)).astype(
        np.float32)

    def chain(device):
        return ImageTransformer(output_col="o", device=device).resize(
            32, 32).resize(48, 48).blur(3, 3).gaussian_kernel(1, 1.0) \
            .threshold(120.0, 255.0, 2).normalize([1.0, 2.0, 3.0],
                                                  [50.0, 60.0, 70.0])
    df = DataFrame({"image": x})
    got = chain(None).transform(df)["o"]
    ref = chain("cpu").transform(df)["o"]
    assert _err(got, ref) <= 1e-5


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("arch", [
    {"builder": "mlp", "hidden": [32], "num_outputs": 4},
    {"builder": "cifar_resnet", "depth": 8, "width": 8, "num_classes": 4}])
def test_nnlearner_fit_card_against_cpu(dev, arch, resident):
    rng = np.random.default_rng(1)
    shape = (16, 16, 3) if arch["builder"] == "cifar_resnet" else (12,)
    x = rng.integers(0, 256, (96, *shape)).astype(np.uint8)
    y = rng.integers(0, 4, 96)
    fn = NNFunction.init(arch, shape, seed=0)
    out = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        learner = NNLearner(model=fn, epochs=2, batch_size=32, log_every=0,
                            learning_rate=0.01, cosine_decay=False,
                            device_resident=resident, device=device)
        model = learner.fit(DataFrame({"features": x, "label": y}))
        out[name] = (np.concatenate(learner.losses),
                     flatten_params(model.model.params), model)
    (lc, pc, mc), (lr, pr, _) = out["card"], out["cpu"]
    assert np.abs(lc - lr).max() <= 1e-4 * np.abs(lr).max()
    for k in pr:
        assert _err(pc[k], pr[k]) <= 1e-4, k
    mc.transform(DataFrame({"features": x[:4]}))
    assert mc.placement()["devices"] == ["cuda:0"]


def test_flip_crop_on_the_card_is_seeded(dev):
    x = torch.rand(32, 32, 32, 3, device=dev)
    a = NNLearner._augment_flip_crop(
        torch.Generator(device=dev).manual_seed(3), x)
    b = NNLearner._augment_flip_crop(
        torch.Generator(device=dev).manual_seed(3), x)
    assert a.device.type == "cuda" and torch.equal(a, b)


def test_image_featurizer_card_against_cpu(dev):
    fn = NNFunction.init({"builder": "cifar_resnet", "depth": 14},
                         (32, 32, 3), seed=0)
    x = np.random.default_rng(2).uniform(0, 1, (64, 40, 40, 3)).astype(
        np.float32)
    kw = dict(model=fn, input_col="image", cut_output_layers=1,
              input_shape=[32, 32, 3], batch_size=32)
    got = ImageFeaturizer(**kw).transform(DataFrame({"image": x}))
    ref = ImageFeaturizer(device="cpu", **kw).transform(
        DataFrame({"image": x}))
    assert _err(got["features"], ref["features"]) <= 1e-4


def test_word2vec_card_against_cpu(dev):
    docs = [["cat", "dog", "pet"], ["car", "road"], ["dog", "cat"]] * 20
    df = DataFrame({"tokens": docs})
    kw = dict(input_col="tokens", vector_size=8, max_iter=3, batch_size=64)
    got = Word2Vec(**kw).fit(df).vectors
    ref = Word2Vec(device="cpu", **kw).fit(df).vectors
    assert _err(got, ref) <= 1e-5


def test_train_classifier_runs_k9_on_the_card(dev):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(512, 16))
    y = (emb[:, 0] + 0.3 * rng.normal(size=512) > 0).astype(int)
    df = DataFrame({"embedding": emb, "label": y})
    CH.reset_launch_counts()
    model = TrainClassifier(model=GBDTClassifier(num_iterations=5,
                                                 num_leaves=7),
                            label_col="label").fit(df)
    assert CH.LAUNCHES["gbdt_histogram"] == 5 * 7
    assert model.fitted.booster.device.type == "cuda"
    cpu = TrainClassifier(model=GBDTClassifier(num_iterations=5,
                                               num_leaves=7, device="cpu"),
                          label_col="label").fit(df)
    a = model.transform(df)["probability"]
    b = cpu.transform(df)["probability"]
    assert _err(a, b) <= 1e-3
