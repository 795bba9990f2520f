"""Parameterize the PyTorch/CUDA port's serving-fleet manifests (the
helm-values analogue; ``tools/k8s/render.py``'s counterpart).

The committed manifests under ``mmlspark_tpu_torch/tools/k8s/`` ARE the
rendered defaults, and this tool re-renders them with overrides —
``helm template --set`` semantics over plain YAML. They run ``python -m
mmlspark_tpu_torch.serving``, and each worker requests one
``nvidia.com/gpu``; for the same values the output is the JAX
package's renderer's but for the image, the module and that resource.

    python -m mmlspark_tpu_torch.tools.k8s.render \
        --set replicas=5 --set image=gcr.io/me/mmlspark-tpu-torch:v2 \
        --set model_uri=gs://me/models/served \
        --set journal_pvc=serving-journal > fleet.yaml
    kubectl apply -f fleet.yaml

Supported values (anything else: edit the YAML, it is the source of
truth): ``replicas`` (worker count), ``image`` (both deployments),
``model_uri``, ``coordinator_url``, ``max_latency_ms``,
``journal_size``, ``stale_after``, ``journal_pvc`` (an existing
PersistentVolumeClaim name: mounts it at ``/journal`` and points each
worker's durable reply journal at a per-pod file there —
exactly-once replies then survive pod crash-restarts), and any worker
env var via ``env.NAME=value`` (including a raw ``env.JOURNAL_PATH``
if you manage the volume yourself). The listen port is deliberately
NOT a value — it is wired through containerPort, the named-port
probes, the Service, and COORDINATOR_URL, so changing it is a YAML
edit, not an override.
"""

import argparse
import os
import sys

import yaml

HERE = os.path.dirname(os.path.abspath(__file__))
MANIFESTS = ("serving-coordinator.yaml", "serving-workers.yaml")


def _containers(doc):
    if doc.get("kind") != "Deployment":
        return []
    return doc["spec"]["template"]["spec"]["containers"]


def _set_env(container, name: str, value: str) -> None:
    env = container.setdefault("env", [])
    for e in env:
        if e.get("name") == name:
            e.clear()
            e.update({"name": name, "value": str(value)})
            return
    env.append({"name": name, "value": str(value)})


def _role(doc) -> str:
    return (doc.get("metadata", {}).get("labels", {}) or {}).get("role", "")


def render(values):
    docs = []
    for fname in MANIFESTS:
        with open(os.path.join(HERE, fname)) as f:
            docs.extend(d for d in yaml.safe_load_all(f) if d)

    env_map = {"model_uri": "MODEL_URI", "coordinator_url": "COORDINATOR_URL",
               "max_latency_ms": "MAX_LATENCY_MS",
               "journal_size": "JOURNAL_SIZE"}
    for doc in docs:
        role = _role(doc)
        for c in _containers(doc):
            if "image" in values:
                c["image"] = values["image"]
            if role == "worker":
                for key, env_name in env_map.items():
                    if key in values:
                        _set_env(c, env_name, values[key])
                if "journal_pvc" in values:
                    # durable journal on a mounted PVC, one file per pod
                    # (replicas must not clobber a shared journal)
                    c.setdefault("volumeMounts", []).append(
                        {"name": "journal", "mountPath": "/journal"})
                    env = c.setdefault("env", [])
                    if not any(e.get("name") == "POD_NAME" for e in env):
                        env.append({"name": "POD_NAME", "valueFrom": {
                            "fieldRef": {"fieldPath": "metadata.name"}}})
                    _set_env(c, "JOURNAL_PATH",
                             "/journal/$(POD_NAME).jsonl")
                for name, v in values.get("env", {}).items():
                    _set_env(c, name, v)
            if role == "coordinator" and "stale_after" in values:
                _set_env(c, "STALE_AFTER", values["stale_after"])
        if role == "worker" and doc.get("kind") == "Deployment":
            if "replicas" in values:
                doc["spec"]["replicas"] = int(values["replicas"])
            if "journal_pvc" in values:
                doc["spec"]["template"]["spec"].setdefault(
                    "volumes", []).append(
                    {"name": "journal", "persistentVolumeClaim":
                        {"claimName": values["journal_pvc"]}})
    return docs


SUPPORTED_KEYS = frozenset({
    "replicas", "image", "model_uri", "coordinator_url", "max_latency_ms",
    "journal_size", "journal_pvc", "stale_after"})


def parse_sets(pairs):
    values = {"env": {}}
    for p in pairs:
        key, sep, val = p.partition("=")
        if not sep:
            raise SystemExit(f"--set needs key=value, got {p!r}")
        if key.startswith("env.") and len(key) > 4:
            values["env"][key[4:]] = val
        elif key in SUPPORTED_KEYS:
            values[key] = val
        else:
            # a typo must not silently deploy the defaults
            raise SystemExit(
                f"unknown --set key {key!r}; supported: "
                f"{', '.join(sorted(SUPPORTED_KEYS))}, env.NAME")
    return values


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a value (repeatable); env.NAME=V sets "
                         "a worker env var")
    args = ap.parse_args()
    docs = render(parse_sets(args.set))
    yaml.safe_dump_all(docs, sys.stdout, sort_keys=False,
                       default_flow_style=False)


if __name__ == "__main__":
    main()
