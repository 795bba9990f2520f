"""SAR recommender with ranking evaluation.

Counterpart of ``examples/recommender_sar.py``: index users and items,
fit SAR (time-decayed affinity times item-item similarity; the
similarity and scoring products on the card), recommend the top 10 for
every user.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import run_main, timed


def make_events(seed: int = 0, n_users: int = 200, n_items: int = 50,
                n_events: int = 4000) -> dict:
    rng = np.random.default_rng(seed)
    # block structure: users prefer items in their own cluster
    users = rng.integers(0, n_users, n_events)
    cluster = users % 5
    items = (cluster * (n_items // 5)
             + rng.integers(0, n_items // 5, n_events))
    noise = rng.integers(0, n_items, n_events)
    items = np.where(rng.random(n_events) < 0.2, noise, items)
    return {"user": [f"u{u}" for u in users],
            "item": [f"i{i}" for i in items],
            "rating": np.ones(n_events),
            "timestamp": rng.integers(1_500_000_000, 1_600_000_000,
                                      n_events)}


def run(device=None, seed: int = 0, n_users: int = 200, n_items: int = 50,
        n_events: int = 4000, k: int = 10) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.recommend import RecommendationIndexer, SAR

    df = DataFrame(make_events(seed, n_users, n_items, n_events))
    with timed() as t:
        indexer = RecommendationIndexer(
            user_input_col="user", item_input_col="item",
            user_output_col="user_idx", item_output_col="item_idx").fit(df)
        indexed = indexer.transform(df)
        sar = SAR(user_col="user_idx", item_col="item_idx",
                  rating_col="rating", timestamp_col="timestamp",
                  similarity_function="jaccard", device=device).fit(indexed)
        recs = sar.recommend_for_all_users(k)
    return {"name": "recommender_sar", "fit_recommend_s": t.seconds,
            "n_users_with_recs": recs.num_rows, "_recs": recs,
            "lines": [f"SAR: fit+recommend {t.seconds:.1f}s, "
                      f"{recs.num_rows} users with top-{k} lists"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
