"""Recommendation: SAR recommender + ranking evaluation infrastructure
(``mmlspark_tpu/recommend``'s names).

Capability parity with the reference's `src/recommendation/` module
(`SAR.scala`, `SARModel.scala`, `RecommendationIndexer.scala`,
`RankingAdapter.scala`, `RankingEvaluator.scala`,
`RankingTrainValidationSplit.scala`): affinity and item-item similarity
are dense products on the card instead of broadcast sparse multiplies
over Spark partitions.
"""

from mmlspark_tpu_torch.recommend.indexer import (
    RecommendationIndexer, RecommendationIndexerModel,
)
from mmlspark_tpu_torch.recommend.sar import SAR, SARModel
from mmlspark_tpu_torch.recommend.ranking import (
    AdvancedRankingMetrics, RankingAdapter, RankingAdapterModel,
    RankingEvaluator, RankingTrainValidationSplit,
    RankingTrainValidationSplitModel, per_user_split,
)

__all__ = [
    "RecommendationIndexer", "RecommendationIndexerModel",
    "SAR", "SARModel",
    "AdvancedRankingMetrics", "RankingAdapter", "RankingAdapterModel",
    "RankingEvaluator", "RankingTrainValidationSplit",
    "RankingTrainValidationSplitModel", "per_user_split",
]
