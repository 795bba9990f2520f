"""The port's frame plane over ``POST /predict``: ``ServingServer``
serving an ``NNModel`` (and a GBDT model) held against the JAX server
on the same requests, on both socket edges, and the port's worker entry
(``python -m mmlspark_tpu_torch.serving coordinator|worker``) as real
subprocesses, as JAX's ``TestEntrypointFleet`` drives its own.

The worker runs on the card unless ``MMLSPARK_TPU_SERVING_CPU=1`` asks
for ``device="cpu"`` on every stage it loads; these tests ask.
Rows: f32 within 1e-5 x max(1, max |ref|) of the JAX server's.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import requests
import torch

from mmlspark_tpu.models.function import NNFunction as JF
from mmlspark_tpu.models.nn import NNModel as JNN
from mmlspark_tpu.serving.server import ServingServer as JServingServer
from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.pipeline import PipelineModel
from mmlspark_tpu_torch.gbdt import GBDTRegressor
from mmlspark_tpu_torch.models.function import NNFunction as PF
from mmlspark_tpu_torch.models.nn import NNModel
from mmlspark_tpu_torch.serving.server import ServingClient, ServingServer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRONTENDS = ["eventloop", "threaded"]
ARCH = {"builder": "cifar_resnet", "depth": 8, "width": 4, "num_classes": 3}


@pytest.fixture(scope="module")
def functions():
    jf = JF.init(ARCH, (8, 8, 1), seed=4)
    return jf, PF(arch=dict(ARCH), params=jax.tree.map(np.asarray, jf.params))


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 8, 8, 1)).astype(
        np.float32)


def _scaled_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def _post_all(base, payloads):
    """All requests at once (they batch), then the replies in order."""
    out = [None] * len(payloads)

    def send(i):
        out[i] = requests.post(base + "/predict", json=payloads[i],
                               timeout=60)
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_predict_rows_match_the_jax_server(functions, frontend):
    jf, pf = functions
    X = _images(12, seed=1)
    payloads = [{"image": x.tolist()} for x in X]
    servers = {
        "port": ServingServer(NNModel(model=pf, input_col="image",
                                      batch_size=8, device="cpu"),
                              port=0, max_batch_size=8, max_latency_ms=20,
                              frontend=frontend),
        "jax": JServingServer(JNN(model=jf, input_col="image",
                                  batch_size=8),
                              port=0, max_batch_size=8, max_latency_ms=20,
                              frontend=frontend)}
    rows = {}
    try:
        for name, srv in servers.items():
            srv.start()
            base = f"http://127.0.0.1:{srv.port}"
            replies = _post_all(base, payloads)
            assert [r.status_code for r in replies] == [200] * 12, name
            rows[name] = np.asarray([r.json()["scores"] for r in replies])
            if name == "port":
                stats = requests.get(base + "/stats", timeout=10).json()
                placement = stats["placement"]
                assert placement["mode"] == "single_device"
                assert placement["devices"] == ["cpu"]
    finally:
        for srv in servers.values():
            srv.stop()
    assert rows["port"].shape == rows["jax"].shape == (12, 3)
    assert _scaled_err(rows["port"], rows["jax"]) <= 1e-5
    direct = NNModel(model=pf, input_col="image", device="cpu").transform(
        DataFrame({"image": X}))["scores"]
    assert _scaled_err(rows["port"], direct) <= 1e-5


def test_uint8_wire_counts_the_frames_bytes(functions):
    """The quantized wire: payloads cast to uint8 at assembly, counted
    in ``serving_wire_bytes_total{dtype="uint8"}`` at the frame's own
    bytes, dequantized on the device; rows within the quantization step
    of the float plane."""
    _, pf = functions
    u8 = np.random.default_rng(2).integers(0, 256, (5, 8, 8, 1),
                                            dtype=np.uint8)
    srv = ServingServer(NNModel(model=pf, input_col="image", device="cpu"),
                        port=0, max_batch_size=8, max_latency_ms=1,
                        bucket_batches=False,
                        quantization={"wire_dtype": "uint8",
                                      "scale": 1.0 / 255.0}).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        got = []
        for x in u8:
            r = requests.post(base + "/predict",
                              json={"image": x.astype(float).tolist()},
                              timeout=60)
            assert r.status_code == 200
            got.append(r.json()["scores"])
        text = requests.get(base + "/metrics", timeout=10).text
    finally:
        srv.stop()
    line = [ln for ln in text.splitlines()
            if ln.startswith('serving_wire_bytes_total{dtype="uint8"}')]
    assert line and float(line[0].split()[-1]) == u8.nbytes
    ref = NNModel(model=pf, input_col="image", device="cpu").transform(
        DataFrame({"image": u8.astype(np.float32) / 255.0}))["scores"]
    assert _scaled_err(got, ref) <= 1e-5


# -- the worker entry as subprocesses -------------------------------------------

def _gbdt_dir(path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 3))
    df = DataFrame({"features": obj_col(list(X)), "label": X[:, 0] * 2.0})
    GBDTRegressor(num_iterations=3, num_leaves=3, min_data_in_leaf=5,
                  device="cpu").fit(df).save(path)
    return path


def _spawn(role, env):
    return subprocess.Popen(
        [sys.executable, "-m", "mmlspark_tpu_torch.serving", role],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _wait_line(proc, word):
    while True:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"{proc.args[-1]} exited rc={proc.poll()} "
                                 f"before {word!r}: {proc.stderr.read()}")
        if word in line:
            return line


def _cpu_env(**kw):
    env = dict(os.environ, MMLSPARK_TPU_SERVING_CPU="1", PORT="0",
               PYTHONPATH=REPO)
    env.update(kw)
    return env


class TestWorkerEntry:

    def test_fleet_serves_and_fails_over(self, tmp_path):
        model_dir = _gbdt_dir(str(tmp_path / "served_model"))
        procs = []
        try:
            coord = _spawn("coordinator", _cpu_env())
            procs.append(coord)
            line = _wait_line(coord, "listening")
            coord_url = f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}"
            for _ in range(2):
                wp = _spawn("worker", _cpu_env(
                    MODEL_URI=model_dir, COORDINATOR_URL=coord_url,
                    POD_IP="127.0.0.1", MAX_LATENCY_MS="1"))
                procs.append(wp)
                _wait_line(wp, "registered")
            client = ServingClient(coord_url, timeout=30)
            assert len(client._workers) == 2
            assert "prediction" in client.predict({"features": [1.0, 0, 0]})
            s = requests.get(client._workers[0].rsplit("/", 1)[0]
                             + "/status", timeout=10).json()
            assert s["n_requests"] >= 1
            procs[1].send_signal(signal.SIGKILL)   # kill one "pod"
            time.sleep(0.3)
            for i in range(6):
                r = client.predict({"features": [float(i), 0.0, 0.0]})
                assert "prediction" in r           # failover kept serving
        finally:
            for p in procs:
                p.kill()
                p.wait(timeout=10)

    def test_worker_serves_a_saved_nnmodel_pipeline(self, functions,
                                                    tmp_path):
        _, pf = functions
        model = PipelineModel(stages=[NNModel(model=pf, input_col="image",
                                              batch_size=8, device="cpu")])
        path = str(tmp_path / "pipe")
        model.save(path)
        X = _images(6, seed=3)
        direct = model.transform(DataFrame({"image": X}))["scores"]
        wp = _spawn("worker", _cpu_env(MODEL_URI=path, MAX_LATENCY_MS="1"))
        try:
            line = _wait_line(wp, "worker serving")
            base = f"http://127.0.0.1:{int(line.strip().rsplit(':', 1)[1])}"
            got = [requests.post(base + "/predict",
                                 json={"image": x.tolist()},
                                 timeout=60).json()["scores"] for x in X]
            assert _scaled_err(got, direct) <= 1e-5
            stats = requests.get(base + "/stats", timeout=10).json()
            assert stats["build"]["frontend"] == "eventloop"
            wp.send_signal(signal.SIGTERM)         # graceful drain
            assert wp.wait(timeout=30) == 0
        finally:
            wp.kill()

    @pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
    def test_worker_without_the_cpu_request_needs_the_card(self, tmp_path):
        model_dir = _gbdt_dir(str(tmp_path / "m"))
        env = _cpu_env(MODEL_URI=model_dir)
        env.pop("MMLSPARK_TPU_SERVING_CPU")
        wp = _spawn("worker", env)
        try:
            out, err = wp.communicate(timeout=120)
        finally:
            wp.kill()
        assert wp.returncode != 0
        assert "no CUDA device" in err


def test_worker_usage_line():
    r = subprocess.run([sys.executable, "-m", "mmlspark_tpu_torch.serving"],
                       cwd=REPO, env=_cpu_env(), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "python -m mmlspark_tpu_torch.serving coordinator|worker" in \
        r.stderr
