"""The frame plane and the dense slot-lane pool on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The
file imports nothing of JAX: the card is held against the port's own
CPU path on the same inputs. Run it on the card with::

    MMLSPARK_TPU_TEST_TPU=1 python -m pytest tests/test_torch_frame_plane_gpu.py

Tolerances, ``max |got - ref| <= tol x max(1, max |ref|)``: f32 1e-5
(the forward holds TF32 off, so cuDNN's f32 convs reassociate only),
bf16 3e-2.
"""

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.models import NNFunction, NNModel
from mmlspark_tpu_torch.models.transformer import (
    TransformerConfig, init_params_np,
)
from mmlspark_tpu_torch.models.zoo import ModelDownloader
from mmlspark_tpu_torch.parallel import cuda_attention as CA
from mmlspark_tpu_torch.serving.decode import (
    DecodeScheduler, TransformerDecoder,
)

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("name", ["digits_resnet8", "digits32_resnet14",
                                  "cifar10s_resnet20"])
def test_zoo_golden_logits_on_the_card(dev, name, tmp_path):
    dl = ModelDownloader(str(tmp_path), repo=os.path.join(REPO, "zoo"))
    meta = dl.download_by_name(name)
    g = np.load(os.path.join(REPO, "tests", "resources",
                             f"golden_{name}.npz"))
    x = g["x"].astype(np.float32)
    if meta.input_dtype == "uint8":
        x = x / 255.0
    got = NNFunction.load(meta.uri).apply(x, device=dev).cpu().numpy()
    np.testing.assert_allclose(got, g["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
@pytest.mark.parametrize("wire", ["auto", "uint8"])
def test_nnmodel_card_matches_cpu(dev, dtype, tol, wire):
    fn = NNFunction.init({"builder": "cifar_resnet", "depth": 20,
                          "dtype": dtype}, (32, 32, 3), seed=0)
    rng = np.random.default_rng(0)
    X = (rng.integers(0, 256, (300, 32, 32, 3), dtype=np.uint8)
         if wire == "uint8"
         else rng.uniform(0, 1, (300, 32, 32, 3)).astype(np.float32))
    kw = dict(input_col="x", batch_size=128, input_dtype=wire)
    card = NNModel(model=fn, **kw).transform(DataFrame({"x": X}))["scores"]
    cpu = NNModel(model=fn, device="cpu", **kw).transform(
        DataFrame({"x": X}))["scores"]
    assert _err(card, cpu) <= tol
    m = NNModel(model=fn, **kw)
    m.transform(DataFrame({"x": X[:4]}))
    assert m.placement()["devices"] == [f"cuda:{torch.cuda.current_device()}"]


def test_dense_pool_on_the_card_launches_no_kernel(dev):
    cfg = TransformerConfig(vocab=256, d_model=64, n_heads=2, d_head=32,
                            d_ff=128, n_stages=1, layers_per_stage=2)
    params = init_params_np(cfg, seed=0)
    rng = np.random.default_rng(0)
    payloads = [{"prompt": rng.integers(1, 256, size=n).tolist(),
                 "max_new_tokens": 6} for n in (3, 9, 17, 30)]
    outs = {}
    for paged in (True, False):
        dec = TransformerDecoder(params, cfg, n_slots=4, max_len=64,
                                 paged=paged)
        ptr = dec.cache["k"].data_ptr()
        sched = DecodeScheduler(dec).start()
        before = dict(CA.LAUNCHES)
        try:
            import json
            import threading

            class P:
                def __init__(self, payload, rid):
                    self.payload, self.rid, self.deadline = payload, rid, None
                    self.event, self.callbacks = threading.Event(), []
                    self.reply = self.status = self.span = None
            pend = [P(p, f"r{i}") for i, p in enumerate(payloads)]
            for p in pend:
                sched.submit(p)
            for p in pend:
                assert p.event.wait(120)
            outs[paged] = [json.loads(p.reply)["tokens"] for p in pend]
        finally:
            sched.stop()
        launched = {k: CA.LAUNCHES[k] - before[k] for k in before}
        if paged:
            assert launched["paged_decode_attention"] > 0
        else:
            assert dec.attn_impl == "dense"
            assert not any(launched.values()), launched
        assert dec.cache["k"].data_ptr() == ptr
        assert sched.pool.n_free == 4
    assert outs[True] == outs[False]
