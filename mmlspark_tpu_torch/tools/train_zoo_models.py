"""Train and publish a model zoo (offline, one-time).

Counterpart of ``tools/train_zoo_models.py``: the same three models,
trained through the port's ``NNLearner`` on the card with the JAX
script's recipes and accuracy gates, published with the port's
``ModelRepo`` (the same manifest format, so the JAX package's
``ModelDownloader`` and ``NNFunction`` read what it writes):

- ``digits_resnet8`` — ResNet-8 on scikit-learn's real 8x8 digits,
  classes 0-7 ONLY (8/9 held out for the transfer-learning example);
- ``digits32_resnet14`` — ResNet-14 on the same digits upscaled to 32x32;
- ``cifar10s_resnet20`` — ResNet-20 on real CIFAR-10 where the standard
  ``cifar-10-batches-py`` files are on disk (``$CIFAR10_DIR``), else on
  the deterministic procedural surrogate (``testing/datagen.synth_cifar``).

Everything goes under the required ``--out`` directory: the zoo repo at
``<out>/zoo`` and each model's golden fixture (probe inputs and their
logits on the CPU, the backend the tests run on) at
``<out>/golden_<name>.npz``. The repo's committed ``zoo/`` and test
fixtures are never written.

    python -m mmlspark_tpu_torch.tools.train_zoo_models digits --out DIR
    python -m mmlspark_tpu_torch.tools.train_zoo_models digits32 --out DIR
    python -m mmlspark_tpu_torch.tools.train_zoo_models cifar --out DIR
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

ARCH = {"builder": "cifar_resnet", "depth": 8, "width": 8, "num_classes": 8}
ARCH_CIFAR = {"builder": "cifar_resnet", "depth": 20, "num_classes": 10}
ARCH_D32 = {"builder": "cifar_resnet", "depth": 14, "num_classes": 8}
#: the JAX script's recipes (``NNLearner`` params) and gates
RECIPES = {
    "digits": dict(arch=ARCH, epochs=40, batch_size=256, learning_rate=0.05,
                   log_every=0, seed=0),
    "digits32": dict(arch=ARCH_D32, epochs=60, batch_size=256,
                     learning_rate=0.04, warmup_steps=100, clip_norm=1.0,
                     device_resident=True, log_every=10, seed=0),
    "cifar": dict(arch=ARCH_CIFAR, epochs=24, batch_size=512,
                  learning_rate=0.05, warmup_steps=200, clip_norm=1.0,
                  device_resident=True, augment="flip_crop", log_every=1,
                  seed=0),
}
FLOOR = 0.95                 # digits and digits32
FLOOR_CIFAR_REAL, FLOOR_CIFAR_SURROGATE = 0.85, 0.90


def load_digits_pretrain_split():
    """Digits 0-7, deterministic train/test split (8/9 left for transfer)."""
    from mmlspark_tpu_torch.examples._common import load_digits
    d = load_digits()
    images = (d["images"] / 16.0).astype(np.float32)[..., None]
    labels = d["target"].astype(np.int64)
    keep = labels < 8
    images, labels = images[keep], labels[keep]
    order = np.random.default_rng(0).permutation(len(images))
    images, labels = images[order], labels[order]
    n_test = 200
    return (images[n_test:], labels[n_test:],
            images[:n_test], labels[:n_test])


def load_digits32_split(device=None):
    """The same split upscaled 8x8 -> 32x32 (``ops.image.resize``)."""
    from mmlspark_tpu_torch.ops.image import resize
    Xtr, ytr, Xte, yte = load_digits_pretrain_split()

    def up(a):
        return resize(torch.as_tensor(a, device=device), 32, 32
                      ).cpu().numpy().astype(np.float32)
    return up(Xtr), ytr, up(Xte), yte


def load_cifar_split(n_train: int = 50_000, n_test: int = 10_000):
    """Real CIFAR-10 if ``$CIFAR10_DIR`` holds the standard batches, else
    the procedural surrogate (classes 0-9)."""
    from mmlspark_tpu_torch.testing.datagen import (
        load_cifar10_batches, synth_cifar)
    d = os.environ.get("CIFAR10_DIR", "")
    if d and os.path.exists(os.path.join(d, "data_batch_1")):
        print(f"using REAL CIFAR-10 from {d}")
        return load_cifar10_batches(d) + ("cifar-10",)
    print("real CIFAR-10 not on disk; using the deterministic procedural "
          "surrogate")
    Xtr, ytr = synth_cifar(n_train, seed=0)
    Xte, yte = synth_cifar(n_test, seed=1_000_003)
    return Xtr, ytr, Xte, yte, "synth-cifar10-v1(procedural)"


def _fit(recipe: dict, X, y, device, epochs=None):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.models.trainer import NNLearner
    kw = dict(recipe)
    if epochs is not None:
        kw["epochs"] = int(epochs)
    return NNLearner(device=device, **kw).fit(
        DataFrame({"features": X, "label": y}))


def _accuracy(model, X, y) -> float:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    scored = model.transform(DataFrame({"features": X, "label": y}))
    return float((np.asarray(scored["scores"]).argmax(axis=1) == y).mean())


def _publish(out: str, fn, name: str, probe, input_scale: float = 1.0,
             **meta) -> dict:
    """Publish ``fn`` into ``<out>/zoo`` and write its golden fixture:
    the probe's logits from the published weights on the CPU."""
    from mmlspark_tpu_torch.models.zoo import ModelDownloader, ModelRepo
    zoo = os.path.join(out, "zoo")
    m = ModelRepo(zoo).publish(name, fn, **meta)
    print(f"published {m.name}: hash={m.hash[:12]}... -> {m.uri}")
    with tempfile.TemporaryDirectory() as cache:
        cpu_fn = ModelDownloader(cache, repo=zoo).load(name)
    logits = cpu_fn.apply(probe.astype(np.float32) * input_scale,
                          device="cpu").numpy().astype(np.float32)
    golden = os.path.join(out, f"golden_{name}.npz")
    np.savez(golden, x=probe, logits=logits,
             test_accuracy=meta.get("acc", np.nan))
    print(f"golden fixture (CPU logits) -> {golden}")
    return {"name": name, "hash": m.hash, "uri": m.uri, "golden": golden}


def train(target: str, out: str, device=None, epochs=None) -> dict:
    """Train ``target`` (digits | digits32 | cifar) and publish it under
    ``out``; raises ``SystemExit`` for a model under its gate."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(123)
    if target == "digits":
        Xtr, ytr, Xte, yte = load_digits_pretrain_split()
        print(f"digits pretrain split: {len(Xtr)} train / {len(Xte)} test")
        floor, dataset = FLOOR, "sklearn-digits(0-7)"
        pub = dict(name="digits_resnet8", model_type="cifar_resnet/8",
                   input_shape=[8, 8, 1], num_classes=8)
        probe = rng.uniform(0, 1, size=(8, 8, 8, 1)).astype(np.float32)
        scale, dtype = 1.0, None
    elif target == "digits32":
        Xtr, ytr, Xte, yte = load_digits32_split(device)
        print(f"digits32 split: {len(Xtr)} train / {len(Xte)} test (REAL "
              f"sklearn digits, upscaled 8x8 -> 32x32)")
        floor, dataset = FLOOR, "sklearn-digits-32x32(0-7)"
        pub = dict(name="digits32_resnet14", model_type="cifar_resnet/14",
                   input_shape=[32, 32, 1], num_classes=8)
        probe = rng.uniform(0, 1, size=(8, 32, 32, 1)).astype(np.float32)
        scale, dtype = 1.0, None
    elif target == "cifar":
        Xtr, ytr, Xte, yte, dataset = load_cifar_split()
        print(f"cifar split: {len(Xtr)} train / {len(Xte)} test "
              f"({dataset})")
        floor = (FLOOR_CIFAR_REAL if dataset == "cifar-10"
                 else FLOOR_CIFAR_SURROGATE)
        pub = dict(name="cifar10s_resnet20", model_type="cifar_resnet/20",
                   input_shape=[32, 32, 3], num_classes=10)
        probe = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
        scale, dtype = 1.0 / 255.0, "uint8"
    else:
        raise SystemExit(f"unknown target {target!r}; use "
                         f"digits|digits32|cifar")
    model = _fit(RECIPES[target], Xtr, ytr, device, epochs)
    acc = _accuracy(model, Xte, yte)
    print(f"test accuracy: {acc:.4f}")
    if acc < floor:
        raise SystemExit(f"refusing to publish a weak model (acc={acc:.3f})")
    extra = {"input_dtype": dtype} if dtype else {}
    name = pub.pop("name")
    out_meta = _publish(out, model.model, name, probe, input_scale=scale,
                        dataset=dataset, **pub, **extra)
    return {**out_meta, "target": target, "accuracy": acc,
            "dataset": dataset, "seconds": time.perf_counter() - t0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", nargs="?", default="digits",
                    choices=("digits", "digits32", "cifar"))
    ap.add_argument("--out", required=True,
                    help="directory for the zoo repo and the fixtures")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the recipe's epochs (a short run "
                         "meets the gate or is refused)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    from mmlspark_tpu_torch.core.environment import resolve_device
    device = str(resolve_device(args.device))
    out = train(args.target, args.out, device, args.epochs)
    if args.json:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
