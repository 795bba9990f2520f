"""The port's tensor-parallel decode and placement helpers against the JAX
package, on the CPU.

``TransformerDecoder(mesh=...)`` on a hosted ``{"data": 1, "model": 2}``
mesh (``dist.train_mesh``) serves ``tests/test_torch_moe_decode.py``'s
greedy payloads through a ``DecodeScheduler``, cold and then through the
prefix cache, for a dense-MLP tree, a token-choice MoE tree (4 experts,
top-2) and a ``quantized_ffn`` tree, on the same weights (the JAX
``init_params`` tree carried across as numpy). Its tokens must equal
JAX's tensor-parallel decoder's (``attn_impl="dense"`` on the 2-device
CPU mesh), the port's single-device decoder's on the paged pool, and
its own on the dense slot-lane pool; its ``placement()`` (and
``/decode/stats``' through ``stats()``) must equal JAX's but for the
devices' names. ``spec_for_leaf``, ``state_specs``, ``placement_label``
and ``tree_bytes`` must equal JAX's on the same shapes.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.parallel import dist as JDIST
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.parallel import dist as PD
from mmlspark_tpu_torch.parallel import topology as TP
from mmlspark_tpu_torch.serving import decode as D
from test_torch_moe_decode import DEC, KW, _payloads, _serve

torch.set_num_threads(1)

TP_SHAPE = {"data": 1, "model": 2}
TREES = {"dense": (KW, {}),
         "moe": (dict(KW, n_experts=4, moe_top_k=2), {}),
         "int8": (KW, {"quantized_ffn": True})}


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return JDIST.train_mesh(shape, devices=jax.devices()[:n])


def _passes(dec, scheduler, hit=True):
    sched = scheduler(dec).start()
    try:
        out = [_serve(sched, _payloads(), "a")]
        if hit:
            out.append(_serve(sched, _payloads(), "b"))
        return out, sched.stats()
    finally:
        sched.stop()


@pytest.fixture(scope="module", params=list(TREES))
def runs(request):
    kw, dkw = TREES[request.param]
    jcfg, cfg = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
    jparams = JT.init_params(jcfg, seed=1)
    tree = jax.tree.map(np.asarray, jparams)
    out = {}
    out["single"] = _passes(D.TransformerDecoder(
        tree, cfg, device="cpu", **DEC, **dkw), D.DecodeScheduler)
    tp = D.TransformerDecoder(tree, cfg, mesh=PD.train_mesh(TP_SHAPE, "cpu"),
                              **DEC, **dkw)
    out["tp_decoder"] = tp
    out["tp"] = _passes(tp, D.DecodeScheduler)
    out["tp_dense_pool"] = _passes(D.TransformerDecoder(
        tree, cfg, mesh=PD.train_mesh(TP_SHAPE, "cpu"), paged=False, **DEC,
        **dkw), D.DecodeScheduler, hit=False)
    out["tp_data2"] = _passes(D.TransformerDecoder(
        tree, cfg, mesh=PD.train_mesh({"data": 2, "model": 2}, "cpu"), **DEC,
        **dkw), D.DecodeScheduler)
    jdec = JD.TransformerDecoder(jparams, jcfg, mesh=_jmesh(TP_SHAPE),
                                 attn_impl="dense", **DEC, **dkw)
    out["jax_tp"] = _passes(jdec, JD.DecodeScheduler)
    out["jax_placement"] = jdec.placement()
    out["single_pool_bytes"] = D.TransformerDecoder(
        tree, cfg, device="cpu", **DEC, **dkw).pool_bytes()
    return out


def test_tp_tokens_equal_jax_tp_and_single_device(runs):
    (single, _), (tp, _), (jtp, _) = runs["single"], runs["tp"], \
        runs["jax_tp"]
    assert tp == jtp
    assert tp == single
    assert runs["tp_data2"][0] == single


def test_tp_dense_pool_tokens_equal_the_paged_pool(runs):
    assert runs["tp_dense_pool"][0][0] == runs["single"][0][0]


def test_placement_equals_jax(runs):
    got = runs["tp_decoder"].placement()
    want = runs["jax_placement"]
    assert got["mode"] == want["mode"] == "tensor_parallel"
    assert got["label"] == want["label"] == "data=1,model=2"
    assert len(got["devices"]) == len(want["devices"])
    assert {k: v for k, v in got.items() if k != "devices"} \
        == {k: v for k, v in want.items() if k != "devices"}
    # /decode/stats carries it
    stats = runs["tp"][1]
    assert stats["placement"] == got
    assert stats["pages"]["pool_bytes"] == runs["tp_decoder"].pool_bytes()


def test_each_rank_pool_holds_half_the_bytes(runs):
    dec = runs["tp_decoder"]
    assert dec.pool_bytes() == runs["single_pool_bytes"]
    assert 2 * dec.pool_bytes_per_rank() == runs["single_pool_bytes"]
    k0, k1 = dec.rank_pool(0)["k"], dec.rank_pool(1)["k"]
    assert k0.shape[-2] == KW["n_heads"] // 2
    assert k0[0].is_contiguous()
    assert k0.data_ptr() != k1.data_ptr()


def test_meshes_the_decoder_refuses():
    cfg = T.TransformerConfig(**KW)
    tree = T.init_params_np(cfg)
    mesh = PD.train_mesh(TP_SHAPE, "cpu")
    with pytest.raises(ValueError, match="n_heads=3 must divide"):
        D.TransformerDecoder(T.init_params_np(T.TransformerConfig(
            **dict(KW, n_heads=3))), T.TransformerConfig(**dict(
                KW, n_heads=3)), mesh=mesh, **DEC)
    dtree, dcfg = T.layer_truncated_draft(tree, cfg, 1)
    with pytest.raises(ValueError, match="speculative decoding with a mesh"):
        D.TransformerDecoder(tree, cfg, mesh=mesh, draft_params=dtree,
                             draft_cfg=dcfg, **DEC)
    with pytest.MonkeyPatch.context() as m:
        # one rank per process: each process holds its heads, its pool
        # its heads' pages (its runs: tests/test_torch_process_axes.py)
        m.setattr(torch.distributed, "get_rank", lambda *a: 1)
        m.setattr(torch.distributed, "get_world_size", lambda *a: 2)
        per_process = TP.Mesh(TP_SHAPE, torch.device("cpu"), hosted=False)
        dec = D.TransformerDecoder(tree, cfg, mesh=per_process, **DEC)
        heads = cfg.n_heads // 2
        assert dec.model_axis is not None and dec.tp == 1
        assert dec.cache["k"].shape[-2] == heads
        np.testing.assert_array_equal(
            dec.params["blocks"][0]["wq"].numpy(),
            tree["blocks"][0]["wq"][..., heads:, :])
    with pytest.raises(ValueError, match="data and model axes"):
        D.TransformerDecoder(tree, cfg, mesh=PD.train_mesh(
            {"model": 2, "seq": 2}, "cpu"), **DEC)
    # the single-device decoder's placement is unchanged
    assert D.TransformerDecoder(tree, cfg, device="cpu", **DEC).placement() \
        == {"mode": "single_device", "n_devices": 1, "device": "cpu"}


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_param_specs_match_jax(quantized):
    for kw in (KW, dict(KW, n_experts=4)):
        if quantized and "n_experts" in kw:
            continue
        got = T.decode_param_specs(T.TransformerConfig(**kw),
                                   PD.train_mesh(TP_SHAPE, "cpu"), quantized)
        want = JT.decode_param_specs(JT.TransformerConfig(**kw),
                                     _jmesh(TP_SHAPE), quantized)
        assert got["embed"] == tuple(want["embed"]) == ()
        for gb, wb in zip(got["blocks"], want["blocks"], strict=True):
            assert gb == {k: tuple(v) for k, v in wb.items()}
    assert T.decode_cache_spec(PD.train_mesh(TP_SHAPE, "cpu")) \
        == tuple(JT.decode_cache_spec(_jmesh(TP_SHAPE)))


SHAPES = [(), (7,), (16, 32), (32, 16), (3, 5), (4, 4), (2, 64, 8),
          (6, 6, 12), (2, 3)]


@pytest.mark.parametrize("shape", [{"data": 1, "model": 2},
                                   {"data": 2, "model": 2},
                                   {"data": 4}, {"model": 4}],
                         ids=["d1m2", "d2m2", "d4", "m4"])
def test_spec_for_leaf_and_label_match_jax(shape):
    pm, jm = PD.train_mesh(shape, "cpu"), _jmesh(shape)
    for s in SHAPES:
        assert PD.spec_for_leaf(s, pm) == tuple(JDIST.spec_for_leaf(s, jm))
    assert PD.placement_label(pm) == JDIST.placement_label(jm)
    tree = {"w": np.zeros((16, 32), np.float32),
            "b": [np.zeros(8, np.float32), np.zeros((4, 4), np.int8)]}
    got = PD.state_specs({k: v if k == "w" else [torch.as_tensor(x)
                                                 for x in v]
                          for k, v in tree.items()}, pm)
    want = JDIST.state_specs(tree, jm)
    assert got["w"] == tuple(want["w"])
    assert [tuple(x) for x in want["b"]] == got["b"]
    assert PD.tree_bytes(tree) == JDIST.tree_bytes(tree)
    report = PD.placement_report(tree, pm)
    jreport = JDIST.placement_report(tree, jm)
    assert {k: v for k, v in report.items() if k != "devices"} \
        == {k: v for k, v in jreport.items() if k != "devices"}
