"""Checkpoint integrity manifests (the port's copy of the digest part of
``mmlspark_tpu/io/checkpoint.py``; the sharded save and restore are not
ported yet).

Every directory checkpoint written through stage persistence
(:func:`mmlspark_tpu_torch.core.serialize.save_stage`) gets a
``checkpoint.sha256.json`` manifest — a per-file SHA-256 listing plus
one combined tree digest — written LAST, so a save that died mid-way
can never present a complete-looking manifest. :func:`verify_digest`
re-hashes the tree against the manifest. The manifest's format is the
JAX package's, byte for byte, so a checkpoint written by either package
verifies in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

from mmlspark_tpu_torch.core.logs import get_logger

logger = get_logger("io.checkpoint")

#: the integrity manifest written beside every stage checkpoint
MANIFEST_FILE = "checkpoint.sha256.json"


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint's content does not match its digest manifest."""


def _iter_files(path: str):
    """Relative paths of every regular file under ``path``, sorted, the
    top-level manifest excluded (it cannot hash itself; NESTED manifests
    — substage checkpoints are checkpoints too — are content like any
    other file)."""
    out = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            rel = os.path.relpath(os.path.join(root, name), path)
            if rel == MANIFEST_FILE:
                continue
            out.append(rel)
    return out


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def compute_digest(path: str,
                   precomputed: Optional[Dict[str, str]] = None
                   ) -> Dict[str, object]:
    """Hash every file under ``path`` into a manifest dict:
    ``{"files": {relpath: sha256}, "digest": <combined tree digest>}``.
    The combined digest hashes the sorted ``relpath:sha256`` lines, so
    it pins both contents AND the file set (a deleted file changes it
    as surely as a flipped bit). ``precomputed`` supplies digests a
    writer hashed while streaming the bytes out (the sharded save
    path), so a multi-GB checkpoint is not read back just to hash it;
    files not covered are hashed from disk as before."""
    precomputed = precomputed or {}
    files = {rel: precomputed.get(rel)
             or _sha256_file(os.path.join(path, rel))
             for rel in _iter_files(path)}
    tree = hashlib.sha256()
    for rel in sorted(files):
        tree.update(f"{rel}:{files[rel]}\n".encode())
    return {"files": files, "digest": tree.hexdigest()}


def write_digest(path: str,
                 precomputed: Optional[Dict[str, str]] = None
                 ) -> Dict[str, object]:
    """Write (atomically: temp file + rename) the integrity manifest
    for the checkpoint directory at ``path`` and return it. Call LAST
    in any save path — an interrupted save must leave a missing or
    stale manifest, never a valid-looking one. ``precomputed`` as in
    :func:`compute_digest`."""
    manifest = compute_digest(path, precomputed=precomputed)
    manifest["algorithm"] = "sha256"
    target = os.path.join(path, MANIFEST_FILE)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, target)
    return manifest


def verify_digest(path: str, strict: bool = False
                  ) -> Tuple[bool, Optional[str]]:
    """Verify the checkpoint at ``path`` against its manifest.

    Returns ``(ok, detail)``. A **missing** manifest is the legacy
    (pre-digest) case: with ``strict=False`` it logs a warning and
    passes (``detail`` says why), with ``strict=True`` it fails — the
    rollout flip-eligibility contract, where "cannot prove integrity"
    must read as "not safe to serve". A **mismatch** (changed bytes,
    missing files, extra files) always fails; callers that load the
    checkpoint raise :class:`CheckpointIntegrityError` on it.
    """
    manifest_path = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(manifest_path):
        detail = ("no integrity manifest (legacy checkpoint saved "
                  "before digests)")
        if strict:
            return False, detail
        logger.warning("checkpoint %s has %s; loading unverified",
                       path, detail)
        return True, detail
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        want = dict(manifest["files"])
    except (ValueError, KeyError, TypeError) as e:
        return False, f"unreadable manifest: {e}"
    have = set(_iter_files(path))
    missing = sorted(set(want) - have)
    if missing:
        return False, f"files missing from checkpoint: {missing[:5]}"
    extra = sorted(have - set(want))
    if extra:
        return False, f"files not in manifest: {extra[:5]}"
    for rel, digest in sorted(want.items()):
        actual = _sha256_file(os.path.join(path, rel))
        if actual != digest:
            return False, (f"digest mismatch for {rel!r}: "
                           f"manifest {digest[:12]}..., "
                           f"file {actual[:12]}...")
    return True, None
