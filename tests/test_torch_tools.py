"""The port's ``trace_dump``, ``gen_docs`` and ``train_zoo_models``
(``mmlspark_tpu_torch.tools``) against the JAX package's ``tools/``, on
the CPU.

- ``trace_dump``: the port's copy runs every mode against a live port
  worker and its coordinator, its replies recorded; ``tools/trace_dump.py``
  then runs the same modes on the recorded replies, and the two print
  byte-identical output (and write byte-identical files). The bundle
  download runs both on one canned incident.
- ``gen_docs``: the same pages, stage names, parameter names and
  defaults as the JAX package's; the port's ``device`` is the one extra
  parameter. Neither writes under ``docs/``.
- ``train_zoo_models``: a short run is refused at the JAX gate; the
  recipe publishes a model the port's ``ModelDownloader`` and JAX's load
  and score alike; nothing under ``zoo/`` or ``tests/resources/`` moves.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import requests
import torch

from mmlspark_tpu_torch.tools import gen_docs, train_zoo_models
from mmlspark_tpu_torch.tools import trace_dump as PTD

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tree_digest(path: str) -> str:
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            p = os.path.join(d, f)
            h.update(os.path.relpath(p, path).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# trace_dump


@pytest.fixture(scope="module")
def fleet():
    """A port worker (host-side doubler, every trace kept, a fast TSDB,
    incident capture on) registered with a port coordinator, after some
    traffic."""
    from mmlspark_tpu_torch.core.stage import Transformer
    from mmlspark_tpu_torch.serving.server import (
        ServingCoordinator, ServingServer)

    class Doubler(Transformer):
        def transform(self, df):
            return df.with_column(
                "y", np.asarray(df["x"], dtype=np.float64) * 2)

    with tempfile.TemporaryDirectory() as tmp:
        srv = ServingServer(Doubler(), max_latency_ms=1, slow_trace_ms=0.0,
                            tsdb={"interval_s": 0.1},
                            incidents={"dir": os.path.join(tmp, "inc")}
                            ).start()
        coord = ServingCoordinator().start()
        coord_url = f"http://{coord.host}:{coord.port}"
        ServingCoordinator.register_worker(coord_url, srv.host, srv.port)
        base = srv.address.rsplit("/", 1)[0]
        for i in range(12):
            requests.post(srv.address, json={"x": float(i)}, timeout=10)
        time.sleep(0.6)        # a few TSDB ticks and profiler samples
        try:
            yield base, coord_url
        finally:
            coord.stop()
            srv.stop()


def _modes(base, coord):
    trace = requests.get(f"{base}/traces", timeout=10).json()[0]["trace_id"]
    fleet = requests.get(f"{coord}/fleet/traces",
                         timeout=10).json()["traces"][0]["trace_id"]
    return {
        "list": [base, "--list"],
        "list_slow": [base, "--list", "--slow"],
        "trace": [base, trace],
        "trace_out": [base, trace, "-o", "{out}/t.json"],
        "slowest_out": [base, "--slowest", "-o", "{out}/s.json"],
        "fleet_list": ["--fleet", coord, "--list"],
        "fleet_trace": ["--fleet", coord, fleet],
        "alerts": [base, "--alerts"],
        "slo": [base, "--slo"],
        "fleet_alerts": ["--fleet", coord, "--alerts"],
        "fleet_slo": ["--fleet", coord, "--slo"],
        "query": [base, "--query", "serving_requests_total"],
        "query_rate": [base, "--query",
                       "rate(serving_requests_total[10s])"],
        "range": [base, "--range", "serving_requests_total", "--window",
                  "10", "--step", "0.5"],
        "fleet_range": ["--fleet", coord, "--range",
                        "serving_requests_total", "--window", "10",
                        "--step", "0.5"],
        "incidents": [base, "--incidents"],
        "fleet_incidents": ["--fleet", coord, "--incidents"],
        "profile": [base, "--profile", "--window", "5"],
        "profile_baseline": [base, "--profile", "--window", "1",
                             "--baseline", "2"],
    }


def _run(mod, argv, capsys):
    """The tool's ``main`` on ``argv`` (the JAX tool reads ``sys.argv``)
    -> the captured output."""
    saved = sys.argv
    try:
        if mod is PTD:
            mod.main(argv)
        else:
            sys.argv = ["trace_dump.py", *argv]
            mod.main()
    except SystemExit as e:      # a mode that ends on a message
        print(f"SystemExit: {e.code}")
    finally:
        sys.argv = saved
    return capsys.readouterr()


def test_trace_dump_prints_jaxs_bytes_on_a_live_worker(fleet, monkeypatch,
                                                       capsys, tmp_path):
    base, coord = fleet
    jtd = jax_tool("trace_dump")
    recorded = {}
    real_json, real_bytes = PTD._get_json, PTD._get_bytes

    def rec_json(url, timeout=10.0):
        recorded[url] = real_json(url, timeout)
        return recorded[url]

    def rec_bytes(url, timeout=30.0):
        recorded[url] = real_bytes(url, timeout)
        return recorded[url]

    def replay(url, timeout=None):
        return recorded[url]

    for name, argv in _modes(base, coord).items():
        outs = []
        for side, mod in (("port", PTD), ("jax", jtd)):
            out_dir = tmp_path / name / side
            out_dir.mkdir(parents=True)
            args = [a.replace("{out}", str(out_dir)) for a in argv]
            with monkeypatch.context() as m:
                if side == "port":
                    m.setattr(mod, "_get_json", rec_json)
                    m.setattr(mod, "_get_bytes", rec_bytes)
                else:
                    m.setattr(mod, "_get_json", replay)
                    m.setattr(mod, "_get_bytes", replay)
                res = _run(mod, args, capsys)
            files = {f: (out_dir / f).read_bytes()
                     for f in sorted(os.listdir(out_dir))}
            text = (res.out + res.err).replace(str(out_dir), "<out>")
            outs.append((text, files))
        assert outs[0] == outs[1], name
        assert outs[0][0].strip(), name


def test_trace_dump_fetches_a_bundle_as_jax_does(monkeypatch, capsys,
                                                 tmp_path):
    """``--incidents --fetch``, worker and fleet, on one canned bundle:
    a verified file, a digest mismatch and an artifact the manifest does
    not list."""
    body = {"alert.json": b'{"state": "firing"}',
            "profile.collapsed": b"main;serve;transform 12\n",
            "logs.json": b"[]"}
    info = {"complete": True, "present": sorted(body),
            "manifest": {"complete": True, "files": {
                "alert.json": {"sha256": hashlib.sha256(
                    body["alert.json"]).hexdigest()},
                "profile.collapsed": {"sha256": "0" * 64}}}}
    inc = "inc-1-001-dispatch_p95_regression"
    replies = {
        f"http://w:1/incidents/{inc}": info,
        "http://c:2/fleet/incidents": {"incidents": [
            {"id": inc, "worker": "w:1", "policy": "p", "at_unix": 0,
             "complete": True, "n_files": 3, "bytes": 2048}]},
        **{f"http://w:1/incidents/{inc}/{k}": v for k, v in body.items()}}
    jtd = jax_tool("trace_dump")
    for argv in (["http://w:1", "--incidents", "--fetch", inc],
                 ["--fleet", "http://c:2", "--incidents", "--fetch", inc],
                 ["--fleet", "http://c:2", "--incidents"]):
        outs = []
        for side, mod in (("port", PTD), ("jax", jtd)):
            out_dir = tmp_path / side / str(len(argv))
            monkeypatch.setattr(mod, "_get_json",
                                lambda u, timeout=None: replies[u])
            monkeypatch.setattr(mod, "_get_bytes",
                                lambda u, timeout=None: replies[u])
            res = _run(mod, argv + ["-o", str(out_dir)], capsys)
            files = ({f: (out_dir / f).read_bytes()
                      for f in sorted(os.listdir(out_dir))}
                     if out_dir.exists() else {})
            outs.append(((res.out + res.err).replace(str(out_dir), "<o>"),
                         files))
        assert outs[0] == outs[1], argv


def test_trace_dump_is_the_jax_tools_code():
    """The port carries the tool over: every function but its docstring,
    usage text and ``main``'s ``argv`` is JAX's, line for line."""
    with open(os.path.join(ROOT, "tools", "trace_dump.py")) as f:
        jax_src = f.read()
    with open(PTD.__file__) as f:
        port_src = f.read()
    body = jax_src[jax_src.index("from __future__"):]
    body = body.replace("def main() -> None:", "def main(argv=None) -> None:")
    body = body.replace("args = ap.parse_args()", "args = ap.parse_args(argv)")
    assert port_src.endswith(body)


# ---------------------------------------------------------------------------
# gen_docs


def _pages(d):
    """{page: {stage: {param: default}}} of a reference directory."""
    out = {}
    for f in sorted(os.listdir(d)):
        if f == "README.md":
            continue
        stages, cur = {}, None
        with open(os.path.join(d, f)) as fh:
            for line in fh:
                if line.startswith("## "):
                    cur = line[3:].strip()
                    stages[cur] = {}
                elif line.startswith("| `") and cur is not None:
                    cells = [c.strip() for c in line.split(" | ")]
                    stages[cur][cells[0].strip("| `")] = cells[1]
        out[f] = stages
    return out


def test_gen_docs_lists_jaxs_stages_and_params(tmp_path, capsys):
    docs = os.path.join(ROOT, "docs")
    before = tree_digest(docs)
    jgen = jax_tool("gen_docs")
    jgen.OUT_DIR = str(tmp_path / "jax")
    jgen.main()
    out = gen_docs.main(["--out", str(tmp_path / "port")])
    assert tree_digest(docs) == before
    assert out["stages"] == 116 and out["pages"] == 10
    jp, pp = _pages(tmp_path / "jax"), _pages(tmp_path / "port")
    assert sorted(pp) == sorted(jp)
    n_device = 0
    for page, stages in jp.items():
        assert list(pp[page]) == list(stages), page
        for stage, params in stages.items():
            got = dict(pp[page][stage])
            if "device" in got and "device" not in params:
                assert got.pop("device") == "`—`"
                n_device += 1
            assert got == params, (page, stage)
    assert n_device == 21
    index = (tmp_path / "port" / "README.md").read_text()
    assert "- [mmlspark_tpu_torch.gbdt](gbdt.md) — " in index


def test_gen_docs_needs_an_out_directory(capsys):
    with pytest.raises(SystemExit):
        gen_docs.main([])


# ---------------------------------------------------------------------------
# train_zoo_models


def test_a_weak_model_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="refusing to publish a weak"):
        train_zoo_models.main(["digits", "--out", str(tmp_path),
                               "--device", "cpu", "--epochs", "1"])
    assert not os.path.exists(tmp_path / "zoo")


def test_the_digits_recipe_publishes_what_jax_loads(tmp_path):
    from mmlspark_tpu.models.function import NNFunction as JF
    from mmlspark_tpu.models.zoo import ModelDownloader as JDown
    from mmlspark_tpu_torch.models.zoo import ModelDownloader
    guarded = [os.path.join(ROOT, d) for d in ("zoo", "tests/resources")]
    before = [tree_digest(d) for d in guarded]
    out = train_zoo_models.main(["digits", "--out", str(tmp_path),
                                 "--device", "cpu", "--json"])
    assert [tree_digest(d) for d in guarded] == before
    assert out["accuracy"] >= train_zoo_models.FLOOR
    zoo = str(tmp_path / "zoo")
    with open(os.path.join(zoo, "manifest.json")) as f:
        entry, = json.load(f)
    assert entry["name"] == "digits_resnet8" and entry["uri"] == \
        "digits_resnet8"
    assert entry["dataset"] == "sklearn-digits(0-7)"
    assert entry["input_shape"] == [8, 8, 1] and entry["num_classes"] == 8
    golden = np.load(out["golden"])
    with tempfile.TemporaryDirectory() as c1, \
            tempfile.TemporaryDirectory() as c2:
        pfn = ModelDownloader(c1, repo=zoo).load("digits_resnet8")
        jd = JDown(c2, repo=zoo)
        assert jd.list_models()["digits_resnet8"].hash == out["hash"]
        jfn = jd.load("digits_resnet8")
    x = golden["x"]
    np.testing.assert_allclose(pfn.apply(x, device="cpu").numpy(),
                               golden["logits"], rtol=0, atol=0)
    jref = JF.load(os.path.join(zoo, "digits_resnet8"))
    for fn in (jfn, jref):
        np.testing.assert_allclose(np.asarray(fn.apply(x)),
                                   golden["logits"], rtol=1e-4, atol=1e-4)
