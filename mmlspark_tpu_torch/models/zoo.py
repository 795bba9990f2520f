"""Model zoo: a repository of checkpointed NNFunctions with manifests.

Capability parity with `src/downloader/` (`ModelDownloader.scala`,
`Schema.scala:54-74`): models live in a repo (a directory or mount) with
per-model JSON metadata (name, dataset, sha256, input node/shape, layer
names); ``ModelDownloader`` fetches them into a local cache with hash
verification and bounded retry (`FaultToleranceUtils.retryWithTimeout`,
`ModelDownloader.scala:37`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional

from mmlspark_tpu_torch.io import fs as _fs
from mmlspark_tpu_torch.models.function import NNFunction


@dataclasses.dataclass
class ModelSchema:
    """Parity: downloader ModelSchema (`Schema.scala:54-74`)."""

    name: str
    dataset: str
    model_type: str
    uri: str
    hash: str
    input_shape: List[int]
    layer_names: List[str]
    num_classes: Optional[int] = None
    # scorer input convention: "uint8" = the net was trained on raw
    # bytes normalized on device — consumers must score with
    # NNModel(input_dtype="uint8"); None = pre-normalized floats
    input_dtype: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ModelSchema":
        return ModelSchema(**d)


def _dir_sha256(path: str) -> str:
    h = hashlib.sha256()
    for rel, full in _fs.walk_rel_files(path):
        h.update(rel.encode())
        with _fs.open_file(full, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def retry_with_timeout(fn, retries: int = 3, backoff: float = 0.5):
    """Parity: FaultToleranceUtils.retryWithTimeout."""
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - retry any fetch failure
            last = e
            if attempt < retries - 1:
                time.sleep(backoff * (2 ** attempt))
    raise last  # type: ignore[misc]


class ModelRepo:
    """A directory of checkpoints + ``manifest.json`` describing them."""

    MANIFEST = "manifest.json"

    def __init__(self, root: str):
        self.root = root

    def _manifest_path(self) -> str:
        return _fs.join(self.root, self.MANIFEST)

    def models(self) -> Dict[str, ModelSchema]:
        if not _fs.exists(self._manifest_path()):
            return {}
        entries = json.loads(_fs.read_text(self._manifest_path()))
        out = {}
        for e in entries:
            meta = ModelSchema.from_json(e)
            # manifests store repo-relative uris so a zoo directory is
            # portable (committed checkpoints work from any clone path;
            # the same manifest works from a gs:// bucket); absolute
            # uris/URLs (e.g. a mount) pass through untouched
            if not _fs.isabs(meta.uri):
                meta = dataclasses.replace(
                    meta, uri=_fs.join(self.root, meta.uri))
            out[meta.name] = meta
        return out

    def publish(self, name: str, fn: NNFunction, dataset: str = "",
                model_type: str = "", input_shape: Optional[List[int]] = None,
                num_classes: Optional[int] = None,
                input_dtype: Optional[str] = None) -> ModelSchema:
        """Add a checkpoint to the repo and record its manifest entry."""
        model_dir = _fs.join(self.root, name)
        if _fs.is_remote(self.root):
            # NNFunction.save writes local files; stage locally, upload.
            # Hash the staged copy — walk_rel_files yields the same
            # rel-sorted order either side, and hashing the remote tree
            # would re-download every byte just published.
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                staged = os.path.join(tmp, name)
                fn.save(staged)
                _fs.rm_tree(model_dir)
                _fs.copy_tree(staged, model_dir)
                tree_hash = _dir_sha256(staged)
        else:
            fn.save(model_dir)
            tree_hash = _dir_sha256(model_dir)
        meta = ModelSchema(
            name=name, dataset=dataset, model_type=model_type,
            uri=name,  # repo-relative: the manifest stays portable
            hash=tree_hash,
            input_shape=list(input_shape or []),
            layer_names=fn.layer_names,
            num_classes=num_classes,
            input_dtype=input_dtype)
        # rewrite from the RAW manifest: models() resolves uris against
        # self.root, and re-serializing resolved paths would bake this
        # machine's absolute paths into the portable manifest
        entries = []
        if _fs.exists(self._manifest_path()):
            entries = [e for e in
                       json.loads(_fs.read_text(self._manifest_path()))
                       if e["name"] != name]
        entries.append(meta.to_json())
        _fs.makedirs(self.root)
        _fs.write_text(self._manifest_path(), json.dumps(entries, indent=2))
        return dataclasses.replace(meta, uri=model_dir)  # resolved for use


class ModelDownloader:
    """Fetch models from a repo into a local cache, verifying hashes.

    Parity: `ModelDownloader.scala` (downloadByName/downloadModel with
    retry + hash check; HDFS repo analogue = any ``gs://``-style fsspec
    URL, `Schema.scala` HDFSRepo). The repo may be a local/NFS path or
    a remote URL; the cache is always local.
    """

    def __init__(self, local_cache: str, repo: Optional[str] = None):
        self.cache_dir = local_cache
        self.repo = ModelRepo(repo) if repo else None

    def list_models(self) -> Dict[str, ModelSchema]:
        if self.repo is None:
            raise ValueError("no repo configured")
        return self.repo.models()

    def download_by_name(self, name: str) -> ModelSchema:
        models = self.list_models()
        if name not in models:
            raise KeyError(f"model {name!r} not in repo; have {sorted(models)}")
        return self.download_model(models[name])

    def download_model(self, meta: ModelSchema) -> ModelSchema:
        dest = os.path.join(self.cache_dir, meta.name)

        if os.path.exists(dest) and _dir_sha256(dest) == meta.hash:
            return dataclasses.replace(meta, uri=dest)

        def fetch():  # only the transfer is retried; it can transiently fail
            if os.path.exists(dest):
                shutil.rmtree(dest)
            os.makedirs(self.cache_dir, exist_ok=True)
            _fs.copy_tree(meta.uri, dest)  # local or gs://-style source

        retry_with_timeout(fetch)
        actual = _dir_sha256(dest)
        if actual != meta.hash:
            # deterministic corruption: fail immediately, no retry
            shutil.rmtree(dest)
            raise IOError(f"hash mismatch for {meta.name}: "
                          f"{actual} != {meta.hash}")
        return dataclasses.replace(meta, uri=dest)

    def load(self, name: str) -> NNFunction:
        meta = self.download_by_name(name)
        return NNFunction.load(meta.uri)
