"""Sequence tagging with the SPMD transformer (entity-extraction era).

Counterpart of ``examples/sequence_tagging.py``: token streams interleave
words with their tags (``w1 t1 w2 t2 ...``), ``build_spmd_train_step``
on a hosted ``{"data": -1}`` mesh learns the tagging language (at 64 x
64 tokens a step the loss runs through the fused CE kernels), and
scoring reads the model's next-token prediction AT the tag positions
(``transformer.reference_logits``). Entity vocabulary: DRUG / DISEASE /
OTHER word families with per-family tags.
"""

from __future__ import annotations

import numpy as np
import torch

from mmlspark_tpu_torch.examples._common import run_main, timed

# token-space layout: word families + tag tokens
DRUG = (10, 40)          # word ids [10, 40) are "drug" mentions
DISEASE = (40, 70)       # [40, 70) are "disease" mentions
OTHER = (70, 150)        # [70, 150) are plain words
TAG_O, TAG_DRUG, TAG_DIS = 3, 4, 5
VOCAB = 160


def tag_of(word: int) -> int:
    if DRUG[0] <= word < DRUG[1]:
        return TAG_DRUG
    if DISEASE[0] <= word < DISEASE[1]:
        return TAG_DIS
    return TAG_O


def make_streams(rng, n: int, length: int):
    """Interleaved word/tag streams ``[w1 t1 w2 t2 ...]`` of ``length``
    tokens (trimmed from whole pairs, so odd lengths work)."""
    n_pairs = (length + 1) // 2
    words = rng.integers(OTHER[0], OTHER[1], size=(n, n_pairs))
    # sprinkle entities: ~30% drug/disease mentions
    ent = rng.random((n, n_pairs))
    words = np.where(ent < 0.15,
                     rng.integers(*DRUG, size=(n, n_pairs)), words)
    words = np.where(ent > 0.85,
                     rng.integers(*DISEASE, size=(n, n_pairs)), words)
    tags = np.vectorize(tag_of)(words)
    stream = np.stack([words, tags], axis=2).reshape(n, 2 * n_pairs)
    return stream[:, :length].astype(np.int32)


def config():
    from mmlspark_tpu_torch.models import transformer as T
    return T.TransformerConfig(vocab=VOCAB, d_model=64, n_heads=4,
                               d_head=16, d_ff=128, layers_per_stage=2)


def run(device=None, seed: int = 0, steps: int = 400, n: int = 64,
        seq: int = 64, n_test: int = 32, init=None,
        gate: bool = True) -> dict:
    """``init``: the initial parameter tree in the JAX ``init_params``
    layout (numpy leaves; default: drawn with numpy from seed 0)."""
    from mmlspark_tpu_torch.models import transformer as T
    from mmlspark_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = config()
    mesh = build_mesh(MeshSpec.from_dict({"data": -1}), device)
    dev = mesh.device
    streams = make_streams(np.random.default_rng(seed), n, seq + 1)
    tokens = torch.as_tensor(streams[:, :-1], device=dev)
    labels = torch.as_tensor(streams[:, 1:], device=dev)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=dev)

    step = T.build_spmd_train_step(cfg, mesh, learning_rate=0.3,
                                   momentum=0.9)
    tree = init if init is not None else T.init_params_np(cfg, seed=0)
    params = T.shard_params(tree, cfg, mesh)
    vel = T.init_velocity(params)
    losses = []
    with timed() as t_train:
        for _ in range(steps):
            params, vel, loss = step(params, vel, tokens, labels, mask)
            losses.append(loss.detach())
        losses = [float(x) for x in losses]
    lines = [f"trained tagger on 1 device(s): final LM loss "
             f"{losses[-1]:.3f} in {t_train.seconds:.1f}s"]

    # score HELD-OUT streams: the tag for word at position 2i is the
    # model's next-token prediction at that position
    test = make_streams(np.random.default_rng(7), n_test, seq + 1)
    with torch.no_grad():
        logits = T.reference_logits(
            params, torch.as_tensor(test[:, :-1], device=dev), cfg)
    logits = logits.cpu().numpy()
    word_pos = np.arange(0, seq, 2)           # words sit at even offsets
    pred_tags = logits[:, word_pos].argmax(-1)
    true_tags = test[:, 1:][:, word_pos]
    acc = float((pred_tags == true_tags).mean())
    ent_mask = true_tags != TAG_O
    ent_recall = float((pred_tags[ent_mask] == true_tags[ent_mask]).mean())
    lines.append(f"held-out tag accuracy {acc:.4f}; entity recall "
                 f"{ent_recall:.4f} over {int(ent_mask.sum())} entity "
                 f"mentions")
    if gate:
        assert acc > 0.95, acc
        assert ent_recall > 0.9, ent_recall
    return {"name": "sequence_tagging", "train_s": t_train.seconds,
            "final_loss": losses[-1], "tag_accuracy": acc,
            "entity_recall": ent_recall, "_losses": np.asarray(losses),
            "_params": T.params_to_numpy(params), "_logits": logits,
            "lines": lines}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
