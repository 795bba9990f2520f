"""AutoML featurization: per-type column handling + vector assembly + text
(``mmlspark_tpu/featurize``'s public names).

Capability parity with `src/featurize` (`Featurize.scala:24`,
`AssembleFeatures.scala:93`) and `src/text-featurizer`
(`TextFeaturizer.scala:179`, `MultiNGram.scala:23`, `PageSplitter.scala:19`).
"""

from mmlspark_tpu_torch.featurize.assemble import (
    VectorAssembler, Featurize, FeaturizeModel,
)
from mmlspark_tpu_torch.featurize.text import (
    Tokenizer, StopWordsRemover, NGram, HashingTF, IDF, IDFModel,
    TextFeaturizer, TextFeaturizerModel, MultiNGram, PageSplitter,
)

__all__ = [
    "VectorAssembler", "Featurize", "FeaturizeModel",
    "Tokenizer", "StopWordsRemover", "NGram", "HashingTF", "IDF", "IDFModel",
    "TextFeaturizer", "TextFeaturizerModel", "MultiNGram", "PageSplitter",
]
