"""The port's deployment files (``mmlspark_tpu_torch/tools/docker/`` and
``mmlspark_tpu_torch/tools/k8s/``) against the JAX package's
(``tools/docker/``, ``tools/k8s/``): for the same ``--set`` values the
port's renderer gives the JAX renderer's manifests but for the image,
the module the pods run and each worker's ``nvidia.com/gpu``."""

import copy
import importlib.util
import os
import subprocess
import sys

import pytest
import yaml

from test_torch_imports import FILES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_K8S = os.path.join(ROOT, "tools", "k8s")
PORT_K8S = os.path.join(ROOT, "mmlspark_tpu_torch", "tools", "k8s")
DOCKERFILE = os.path.join(ROOT, "mmlspark_tpu_torch", "tools", "docker",
                          "Dockerfile")
GPU = "nvidia.com/gpu"
SETS = {
    "defaults": [],
    "overrides": ["replicas=5", "image=gcr.io/me/fleet:v2",
                  "model_uri=gs://me/models/m", "journal_pvc=serving-journal",
                  "stale_after=45", "max_latency_ms=20",
                  "env.REGISTER_INTERVAL=5"],
}


def _renderer(directory, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(directory, "render.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _as_jax(doc, jax_doc):
    """A port manifest with the three permitted differences undone: the
    image and the module as the JAX manifest's, the GPU resource gone."""
    doc = copy.deepcopy(doc)
    if doc.get("kind") != "Deployment":
        return doc
    ours = doc["spec"]["template"]["spec"]["containers"]
    theirs = jax_doc["spec"]["template"]["spec"]["containers"]
    for c, j in zip(ours, theirs):
        c["image"] = j["image"]
        assert c["command"][:3] == ["python", "-m",
                                    "mmlspark_tpu_torch.serving"]
        c["command"] = j["command"]
        res = c.get("resources", {})
        for kind in ("requests", "limits"):
            res.get(kind, {}).pop(GPU, None)
        if res.get("limits") == {}:
            del res["limits"]
    return doc


@pytest.mark.parametrize("sets", sorted(SETS))
def test_render_is_jaxs_but_the_image_module_and_gpu(sets):
    jax_docs = _renderer(JAX_K8S, "jax_render").render(
        _renderer(JAX_K8S, "jax_render").parse_sets(SETS[sets]))
    port = _renderer(PORT_K8S, "port_render")
    docs = port.render(port.parse_sets(SETS[sets]))
    assert len(docs) == len(jax_docs) == 3
    for doc, jdoc in zip(docs, jax_docs):
        assert _as_jax(doc, jdoc) == jdoc
    workers = [d for d in docs if d["kind"] == "Deployment"
               and d["metadata"]["labels"]["role"] == "worker"]
    (worker,) = workers
    for c in worker["spec"]["template"]["spec"]["containers"]:
        assert c["resources"]["limits"][GPU] == 1
        assert c["resources"]["requests"][GPU] == 1
        assert c["command"] == ["python", "-m", "mmlspark_tpu_torch.serving",
                                "worker"]
    images = {c["image"] for d in docs if d["kind"] == "Deployment"
              for c in d["spec"]["template"]["spec"]["containers"]}
    assert images == ({"gcr.io/me/fleet:v2"} if sets == "overrides"
                      else {"mmlspark-tpu-torch:latest"})


@pytest.mark.parametrize("fname", ["serving-coordinator.yaml",
                                   "serving-workers.yaml"])
def test_manifests_parse_and_are_the_rendered_defaults(fname):
    with open(os.path.join(PORT_K8S, fname)) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    assert {d["kind"] for d in docs} <= {"Deployment", "Service"}
    port = _renderer(PORT_K8S, "port_render")
    rendered = port.render(port.parse_sets([]))
    for doc in docs:
        assert doc in rendered


def test_the_renderer_runs_as_a_module():
    p = subprocess.run([sys.executable, "-m",
                        "mmlspark_tpu_torch.tools.k8s.render", "--set",
                        "replicas=2"], capture_output=True, text=True,
                       cwd=ROOT, timeout=60)
    assert p.returncode == 0, p.stderr[-2000:]
    docs = [d for d in yaml.safe_load_all(p.stdout) if d]
    assert [d["spec"]["replicas"] for d in docs
            if d["kind"] == "Deployment"
            and d["metadata"]["labels"]["role"] == "worker"] == [2]
    p = subprocess.run([sys.executable, "-m",
                        "mmlspark_tpu_torch.tools.k8s.render", "--set",
                        "replica=2"], capture_output=True, text=True,
                       cwd=ROOT, timeout=60)
    assert p.returncode != 0 and "unknown --set key" in p.stderr


def test_dockerfile_is_a_cuda_devel_image_running_the_port():
    with open(DOCKERFILE) as f:
        lines = [ln.strip() for ln in f if ln.strip()
                 and not ln.lstrip().startswith("#")]
    base = [ln for ln in lines if ln.startswith("FROM ")]
    assert len(base) == 1
    image = base[0].split()[1]
    assert image.startswith("nvidia/cuda:12.8") and "devel" in image
    # the torch the port has been run with on the card, for CUDA 12.8
    assert any("torch==2.11.0" in ln for ln in lines)
    assert any("whl/cu128" in ln for ln in lines)
    assert any("g++" in ln and "zlib1g-dev" in ln for ln in lines)
    (cmd,) = [ln for ln in lines if ln.startswith("CMD ")]
    assert "mmlspark_tpu_torch.serving" in cmd
    text = "\n".join(lines)
    assert "mmlspark_tpu." not in text.replace("mmlspark_tpu_torch", "")
    assert "jax" not in text


def test_the_import_scan_covers_the_renderer():
    from pathlib import Path
    assert Path(PORT_K8S, "render.py") in FILES
