"""The port's load drivers and test kit (``mmlspark_tpu_torch/testing/``:
``decode_load``, ``load``, ``datagen``, ``benchmarks``) against the JAX
package's, on the CPU.

* Decode drivers: both packages' ``make_workload`` give the same jobs;
  with every ``arrival_s`` at 0, the port's ``run_continuous``,
  ``run_static`` and ``run_scheduler_sessions`` (paged with prefix
  sharing, and speculative) over weights bridged from JAX
  (``params_from_jax``) equal JAX's in ``tokens``, in each job's
  ``n_tokens`` and in the sessions' token sequences, with 0 recompiles
  and the pool in place.
* HTTP driver: the port's ``drive_keepalive`` and JAX's, against the
  port's ``ServingServer`` on localhost (plain and TLS, both socket
  edges), count the same requests, statuses and connections.
* ``datagen`` frames equal JAX's cell for cell from the same seed, and
  ``Benchmarks`` passes ``tests/test_benchmarks.py``'s cases.

No assertion reads a wall-clock rate.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import transformer as JT
from mmlspark_tpu.serving import decode as JD
from mmlspark_tpu.testing import datagen as JDG
from mmlspark_tpu.testing import decode_load as JDL
from mmlspark_tpu.testing import load as JLOAD
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.models import transformer as T
from mmlspark_tpu_torch.serving import decode as D
from mmlspark_tpu_torch.serving.server import ServingServer
from mmlspark_tpu_torch.testing import Benchmarks
from mmlspark_tpu_torch.testing import datagen as PDG
from mmlspark_tpu_torch.testing import decode_load as PDL
from mmlspark_tpu_torch.testing import load as PLOAD
from mmlspark_tpu_torch.testing.tls import (
    client_context, generate_self_signed_cert, tls_supported,
)

torch.set_num_threads(1)

KW = dict(vocab=64, d_model=16, n_heads=2, d_head=8, d_ff=32, n_stages=1,
          layers_per_stage=2)
JCFG = JT.TransformerConfig(**KW)
CFG = T.TransformerConfig(**KW)
JPARAMS = JT.init_params(JCFG, seed=0)
NPARAMS = jax.tree.map(np.asarray, JPARAMS)
DEC = dict(n_slots=4, max_len=64, page_size=8)
WORKLOAD = dict(vocab=64, n_requests=10, seed=3, mean_gap_ms=3.0,
                max_new=(4, 9, 14))


def _jobs(mod, **kw):
    """A workload with every request arrived at 0: the admission order
    then depends on no clock."""
    jobs = mod.make_workload(**dict(WORKLOAD, **kw))
    for j in jobs:
        j.arrival_s = 0.0
    return jobs


def _same_jobs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.arrival_s == y.arrival_s
        assert x.max_new == y.max_new
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("share", [0.0, 0.5])
def test_make_workload_equals_jax(share):
    _same_jobs(PDL.make_workload(**WORKLOAD, prefix_share=share),
               JDL.make_workload(**WORKLOAD, prefix_share=share))


@pytest.mark.parametrize("run", ["run_continuous", "run_static"])
def test_batching_drivers_equal_jax(run):
    pj, jj = _jobs(PDL), _jobs(JDL)
    _same_jobs(pj, jj)
    port = getattr(PDL, run)(D.TransformerDecoder(NPARAMS, CFG,
                                                  device="cpu", **DEC), pj)
    ref = getattr(JDL, run)(JD.TransformerDecoder(JPARAMS, JCFG, **DEC), jj)
    assert port["mode"] == ref["mode"]
    assert port["tokens"] == ref["tokens"] > 0
    assert [j.n_tokens for j in pj] == [j.n_tokens for j in jj]
    assert [j.n_tokens for j in pj] == [j.max_new for j in pj]
    assert port["post_warmup_recompiles"] == 0
    if run == "run_continuous":
        assert port["cache_buffer_stable"] and ref["cache_buffer_stable"]
        # the CPU keeps no live-allocation count
        assert port["live_array_growth"] is None


def _spec_pair():
    """JAX's tempered model pair, its trees carried across as numpy."""
    tree, dtree, dcfg = JDL.make_spec_model_pair(JCFG, draft_layers=1,
                                                 resid_scale=0.05, seed=0)
    return tree, dtree, dcfg


@pytest.fixture(scope="module")
def sessions():
    """Each package's scheduler sessions over the same jobs: a paged
    scheduler with prefix sharing, and a speculative one."""
    tree, dtree, dcfg = _spec_pair()
    ntree, ndtree = (jax.tree.map(np.asarray, t) for t in (tree, dtree))
    pdcfg = T.TransformerConfig(**{
        f.name: getattr(dcfg, f.name) for f in dataclasses.fields(dcfg)
        if f.name in {g.name for g in dataclasses.fields(
            T.TransformerConfig)}})
    scheds = {
        "paged": (D.DecodeScheduler(D.TransformerDecoder(
            NPARAMS, CFG, device="cpu", **DEC)),
            JD.DecodeScheduler(JD.TransformerDecoder(JPARAMS, JCFG,
                                                     **DEC))),
        "speculative": (D.DecodeScheduler(D.TransformerDecoder(
            ntree, CFG, device="cpu", draft_params=ndtree,
            draft_cfg=pdcfg, spec_k=3, **DEC)),
            JD.DecodeScheduler(JD.TransformerDecoder(
                tree, JCFG, draft_params=dtree, draft_cfg=dcfg, spec_k=3,
                **DEC))),
    }
    out = {}
    for name, (ps, js) in scheds.items():
        share = 0.5 if name == "paged" else 0.0
        res = []
        for sched, mod in ((ps, PDL), (js, JDL)):
            sched.start()
            try:
                res.append(mod.run_scheduler_sessions(
                    sched, _jobs(mod, prefix_share=share), timeout_s=120))
            finally:
                sched.stop()
        out[name] = res
    return out


@pytest.mark.parametrize("name", ["paged", "speculative"])
def test_scheduler_sessions_equal_jax(sessions, name):
    port, ref = sessions[name]
    assert port["errors"] == ref["errors"] == 0
    assert port["tokens"] == ref["tokens"] > 0
    assert port["sequences"] == ref["sequences"]
    assert port["post_warmup_recompiles"] == 0
    assert port["cache_buffer_stable"]
    assert port["slots_all_freed"] and port["pages_all_freed"]
    for key in ("n_requests", "slots_all_freed", "pages_all_freed"):
        assert port[key] == ref[key], key
    if name == "paged":
        assert port["prefix_cache"]["hits"] == ref["prefix_cache"]["hits"]
        assert port["prefix_cache"]["hits"] > 0
    else:
        assert port["spec_rounds"] > 0
        assert port["acceptance_rate"] == ref["acceptance_rate"]


# -- the keep-alive HTTP driver -----------------------------------------------

class Doubler(Transformer):
    def transform(self, df):
        return df.with_column("y", np.asarray(df["x"], np.float64) * 2)


_DRIVEN = ("n_connections", "n_connected", "requests", "conn_errors",
           "http_errors", "reuse_rate")


def _drive(mod, srv, path, payload, **kw):
    out = mod.drive_keepalive("127.0.0.1", srv.port, path, payload,
                              n_connections=6, requests_per_conn=4,
                              settle_timeout=30.0, **kw)
    return {k: out[k] for k in _DRIVEN}


@pytest.mark.parametrize("frontend", ["eventloop", "threaded"])
def test_keepalive_driver_counts_equal_jax(frontend):
    with ServingServer(Doubler(), port=0, max_latency_ms=1,
                       frontend=frontend, verify_checkpoints=False) as srv:
        for path, payload in (("/predict", b'{"x": 1.5}'),
                              ("/nowhere", b'{"x": 1.5}'),
                              ("/predict", b'{"x": ')):
            port = _drive(PLOAD, srv, path, payload)
            ref = _drive(JLOAD, srv, path, payload)
            assert port == ref, (path, payload)
            if path == "/predict" and payload.endswith(b"}"):
                assert port["requests"] == 24
                assert port["http_errors"] == port["conn_errors"] == 0
            else:
                # every reply an error (an edge may close after one)
                assert port["http_errors"] == port["requests"] >= 6


@pytest.mark.skipif(not tls_supported()[0],
                    reason="needs the ssl module and the openssl CLI")
def test_keepalive_driver_over_tls_equals_jax(tmp_path):
    cert, key = generate_self_signed_cert(str(tmp_path))
    with ServingServer(Doubler(), port=0, max_latency_ms=1,
                       tls_cert=cert, tls_key=key,
                       verify_checkpoints=False) as srv:
        kw = dict(ssl_context=client_context(cert),
                  tls_server_hostname="localhost")
        port = _drive(PLOAD, srv, "/predict", b'{"x": 2.0}', **kw)
        ref = _drive(JLOAD, srv, "/predict", b'{"x": 2.0}', **kw)
    assert port == ref
    assert port["requests"] == 24 and port["http_errors"] == 0
    assert port["conn_errors"] == 0


def test_build_request_equals_jax():
    args = ("h:1", "/predict", b'{"x": 1}', [("X-Api-Key", "k")])
    assert PLOAD.build_request(*args) == JLOAD.build_request(*args)


# -- datagen and the CSV gate -------------------------------------------------

def _same_frame(a, b):
    assert a.columns == b.columns
    for name in a.columns:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype, name
        if x.dtype == np.dtype("O"):
            assert list(x) == list(y), name
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("missing", [0.0, 0.3])
def test_basic_mixed_frame_equals_jax(missing):
    _same_frame(PDG.basic_mixed_frame(48, seed=5, missing_ratio=missing),
                JDG.basic_mixed_frame(48, seed=5, missing_ratio=missing))


def test_generated_frame_equals_jax():
    def schema(mod):
        return {"x": mod.ColumnOptions("double", missing_ratio=0.5),
                "s": mod.ColumnOptions("string", missing_ratio=0.3),
                "v": mod.ColumnOptions("vector", dim=5),
                "c": mod.ColumnOptions("categorical", levels=("p", "q")),
                "i": mod.ColumnOptions("int", low=-3, high=9)}
    port = PDG.generate_dataframe(schema(PDG), 200, seed=1)
    _same_frame(port, JDG.generate_dataframe(schema(JDG), 200, seed=1))
    assert port.num_rows == 200
    with pytest.raises(ValueError, match="not representable"):
        PDG.generate_column(np.random.default_rng(0), 4,
                            PDG.ColumnOptions("int", missing_ratio=0.1))


def test_synth_cifar_equals_jax():
    a, la = PDG.synth_cifar(24, seed=2, classes=tuple(range(12)))
    b, lb = JDG.synth_cifar(24, seed=2, classes=tuple(range(12)))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def test_benchmarks_pass_and_drift(tmp_path):
    path = tmp_path / "benchmarks_demo.csv"
    path.write_text("name,value,precision\nm1,1.0,0.1\nm2,5.0,0.5\n")
    ok = Benchmarks(str(tmp_path), "demo")
    ok.add("m1", 1.05)
    ok.add("m2", 4.8)
    ok.verify()
    bad = Benchmarks(str(tmp_path), "demo")
    bad.add("m1", 1.5)
    bad.add("m2", 4.8)
    with pytest.raises(AssertionError, match="m1"):
        bad.verify()
    assert (tmp_path / "new_benchmarks_demo.csv").exists()


def test_benchmarks_missing_extra_and_first_run(tmp_path):
    (tmp_path / "benchmarks_d2.csv").write_text(
        "name,value,precision\nm1,1.0,0.1\n")
    b = Benchmarks(str(tmp_path), "d2")
    b.add("m_new", 2.0)
    with pytest.raises(AssertionError) as e:
        b.verify()
    assert "m_new" in str(e.value) and "m1" in str(e.value)
    fresh = Benchmarks(str(tmp_path), "fresh")
    fresh.add("m", 3.0)
    with pytest.raises(AssertionError, match="no committed"):
        fresh.verify()
    written = (tmp_path / "new_benchmarks_fresh.csv").read_text()
    # the same file the JAX harness writes
    from mmlspark_tpu.testing import Benchmarks as JB
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jb = JB(str(jdir), "fresh")
    jb.add("m", 3.0)
    with pytest.raises(AssertionError):
        jb.verify()
    assert (jdir / "new_benchmarks_fresh.csv").read_text() == written
