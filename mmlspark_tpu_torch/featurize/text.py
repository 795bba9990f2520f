"""Text featurization: tokenize → stopwords → n-grams → TF(-IDF).

The port's copy of ``mmlspark_tpu/featurize/text.py``; ``Word2Vec``
trains on the card (autograd SGD on tensors) where JAX jits its step.

Capability parity with `src/text-featurizer`
(`TextFeaturizer.scala:179,386`): a composable pipeline builder producing a
feature-vector column from raw text, plus `MultiNGram` (parallel n-gram
lengths, `MultiNGram.scala:23`) and `PageSplitter` (bounded-length text
paging for HTTP services, `PageSplitter.scala:19`).

String processing is host-side; the produced TF/TF-IDF matrices are dense
float arrays ready for device upload.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core import schema as S
from mmlspark_tpu_torch.core.params import (
    Param, HasDevice, HasInputCol, HasOutputCol, in_range,
)
from mmlspark_tpu_torch.core.stage import Transformer, Estimator, Model
from mmlspark_tpu_torch.core.pipeline import Pipeline, PipelineModel


from mmlspark_tpu_torch.core.dataframe import obj_col as _obj_col  # shared helper


def hash_token(token: str, dims: int) -> int:
    """Stable token -> slot hash (murmur-free: md5 low 8 bytes mod dims)."""
    h = hashlib.md5(token.encode("utf-8", "ignore")).digest()
    return int.from_bytes(h[:8], "little") % dims


# A compact English stopword list (Spark ML's default list, reduced).
ENGLISH_STOP_WORDS = frozenset("""
a about above after again against all am an and any are as at be because
been before being below between both but by could did do does doing down
during each few for from further had has have having he her here hers
herself him himself his how i if in into is it its itself just me more
most my myself no nor not now of off on once only or other our ours
ourselves out over own same she should so some such than that the their
theirs them themselves then there these they this those through to too
under until up very was we were what when where which while who whom why
will with you your yours yourself yourselves
""".split())


class Tokenizer(Transformer, HasInputCol, HasOutputCol):
    """Regex tokenizer (parity: Spark RegexTokenizer inside TextFeaturizer)."""

    pattern = Param(r"\W+", "split pattern (gaps=True semantics)", ptype=str)
    to_lowercase = Param(True, "lowercase before splitting", ptype=bool)
    min_token_length = Param(1, "drop shorter tokens", ptype=int)

    def transform(self, df: DataFrame) -> DataFrame:
        pat = re.compile(self.pattern)
        out: List[List[str]] = []
        for text in df[self.input_col]:
            s = str(text)
            if self.to_lowercase:
                s = s.lower()
            toks = [t for t in pat.split(s) if len(t) >= self.min_token_length]
            out.append(toks)
        return df.with_column(self.output_col, _obj_col(out))


class StopWordsRemover(Transformer, HasInputCol, HasOutputCol):
    stop_words = Param(None, "stopword list (default: English)", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        stops = set(self.stop_words) if self.stop_words is not None \
            else ENGLISH_STOP_WORDS
        out = [[t for t in toks if t not in stops]
               for toks in df[self.input_col]]
        return df.with_column(self.output_col, _obj_col(out))


class NGram(Transformer, HasInputCol, HasOutputCol):
    n = Param(2, "n-gram length", ptype=int, validator=in_range(lo=1))

    def transform(self, df: DataFrame) -> DataFrame:
        n = self.n
        out = [[" ".join(toks[i:i + n]) for i in range(len(toks) - n + 1)]
               for toks in df[self.input_col]]
        return df.with_column(self.output_col, _obj_col(out))


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams of several lengths (parity: `MultiNGram.scala:23`)."""

    lengths = Param(None, "n-gram lengths, e.g. [1,2,3]", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        lengths = [int(x) for x in (self.lengths or [1, 2, 3])]
        out: List[List[str]] = []
        for toks in df[self.input_col]:
            grams: List[str] = []
            for n in lengths:
                grams.extend(" ".join(toks[i:i + n])
                             for i in range(len(toks) - n + 1))
            out.append(grams)
        return df.with_column(self.output_col, _obj_col(out))


class HashingTF(Transformer, HasInputCol, HasOutputCol):
    """Token list -> hashed term-frequency vector."""

    num_features = Param(1 << 12, "vector dims", ptype=int,
                         validator=in_range(lo=1))
    binary = Param(False, "presence (1.0) instead of counts", ptype=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        dims = self.num_features
        tf = np.zeros((df.num_rows, dims), dtype=np.float64)
        for i, toks in enumerate(df[self.input_col]):
            for tok in toks:
                j = hash_token(tok, dims)
                tf[i, j] = 1.0 if self.binary else tf[i, j] + 1.0
        meta = S.make_features_meta(
            [f"{self.input_col}#tf{j}" for j in range(dims)])
        return df.with_column(self.output_col, tf, metadata=meta)


class IDF(Estimator, HasInputCol, HasOutputCol):
    """Inverse-document-frequency scaling over a TF vector column."""

    min_doc_freq = Param(0, "ignore terms in fewer docs", ptype=int)

    def fit(self, df: DataFrame) -> "IDFModel":
        tf = np.asarray(df[self.input_col], dtype=np.float64)
        n_docs = len(tf)
        doc_freq = np.sum(tf > 0, axis=0)
        idf = np.log((n_docs + 1.0) / (doc_freq + 1.0))
        if self.min_doc_freq > 0:
            idf = np.where(doc_freq >= self.min_doc_freq, idf, 0.0)
        return IDFModel(input_col=self.input_col,
                        output_col=self.output_col, idf=idf.tolist())


class IDFModel(Model, HasInputCol, HasOutputCol):
    idf = Param(None, "per-slot idf weights", ptype=list)

    def transform(self, df: DataFrame) -> DataFrame:
        tf = np.asarray(df[self.input_col], dtype=np.float64)
        out = tf * np.asarray(self.idf, dtype=np.float64)[None, :]
        return df.with_column(self.output_col, out,
                              metadata=df.get_metadata(self.input_col))


class Word2Vec(Estimator, HasInputCol, HasOutputCol, HasDevice):
    """Skip-gram word embeddings with negative sampling, on the card.

    Parity: the `useWord2Vec` path of the reference's text pipeline
    (`TextFeaturizer.scala:179` wraps Spark ML Word2Vec). The classic
    SGNS objective is trained by autograd SGD over batched (center,
    context, negatives) triples on the stage's device (the card unless
    ``device="cpu"``); the initial values, the pair order and the
    negatives come from JAX's numpy stream, so the vectors are
    deterministic and match JAX's. Documents are embedded as the mean
    of their token vectors (Spark ML semantics).
    """

    vector_size = Param(32, "embedding dimension", ptype=int)
    window = Param(5, "context window radius", ptype=int)
    min_count = Param(1, "min token frequency", ptype=int)
    negatives = Param(5, "negative samples per pair", ptype=int)
    step_size = Param(0.05, "SGD learning rate", ptype=float)
    max_iter = Param(1, "epochs over the pair set", ptype=int)
    batch_size = Param(4096, "pairs per step", ptype=int)
    seed = Param(0, "random seed", ptype=int)

    def fit(self, df: DataFrame) -> "Word2VecModel":
        import torch
        import torch.nn.functional as F

        from mmlspark_tpu_torch.core.environment import resolve_device
        dev = resolve_device(self.device)

        docs = [list(d) for d in df[self.input_col]]
        counts: Dict[str, int] = {}
        for doc in docs:
            for tok in doc:
                counts[tok] = counts.get(tok, 0) + 1
        vocab = sorted(t for t, c in counts.items() if c >= self.min_count)
        index = {t: i for i, t in enumerate(vocab)}
        V, D = max(len(vocab), 1), self.vector_size

        rng = np.random.default_rng(self.seed)
        centers: List[int] = []
        contexts: List[int] = []
        for doc in docs:
            ids = [index[t] for t in doc if t in index]
            for i, c in enumerate(ids):
                lo = max(0, i - self.window)
                for j in range(lo, min(len(ids), i + self.window + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        if not centers:  # degenerate corpus: zero vectors
            return Word2VecModel(
                input_col=self.input_col,
                output_col=self.output_col or f"{self.input_col}_w2v",
                vocab=list(vocab), vectors=np.zeros((V, D), np.float32))

        # unigram^(3/4) negative-sampling table (word2vec's choice)
        freq = np.array([counts[t] for t in vocab], np.float64) ** 0.75
        neg_p = freq / freq.sum()

        emb_in = (rng.uniform(-0.5, 0.5, (V, D)) / D).astype(np.float32)
        e_in = torch.from_numpy(emb_in).to(dev).requires_grad_(True)
        e_out = torch.zeros((V, D), dtype=torch.float32,
                            device=dev).requires_grad_(True)
        lr, K = self.step_size, self.negatives

        def step(c_idx, ctx_idx, neg_idx):
            vc = e_in[c_idx]                          # (B, D)
            pos = torch.einsum("bd,bd->b", vc, e_out[ctx_idx])
            neg = torch.einsum("bd,bkd->bk", vc, e_out[neg_idx])
            loss = -(F.logsigmoid(pos).mean()
                     + F.logsigmoid(-neg).sum(dim=1).mean())
            g_in, g_out = torch.autograd.grad(loss, (e_in, e_out))
            with torch.no_grad():
                e_in.sub_(lr * g_in)
                e_out.sub_(lr * g_out)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        pairs = np.stack([centers, contexts], axis=1)
        B = max(1, min(self.batch_size, len(pairs)))  # static per fit
        for _ in range(max(self.max_iter, 1)):
            order = rng.permutation(len(pairs))
            for s in range(0, len(pairs), B):
                batch = pairs[order[s:s + B]]
                if len(batch) < B:  # fixed shapes: wrap the tail around
                    batch = np.concatenate(
                        [batch, pairs[order[:B - len(batch)]]], axis=0)
                negs = rng.choice(V, size=(B, K), p=neg_p)
                step(put(batch[:, 0]), put(batch[:, 1]), put(negs))

        return Word2VecModel(
            input_col=self.input_col,
            output_col=self.output_col or f"{self.input_col}_w2v",
            vocab=list(vocab), vectors=e_in.detach().cpu().numpy())


class Word2VecModel(Model, HasInputCol, HasOutputCol):
    """Token lists -> mean-of-embeddings document vectors."""

    vocab = Param(None, "vocabulary (index-aligned with vectors)",
                  ptype=list)
    vectors = Param(None, "embedding matrix (V, D)", complex=True)

    def find_synonyms(self, word: str, num: int = 5) -> List[Tuple[str, float]]:
        """Nearest vocabulary words by cosine similarity."""
        if word not in self.vocab:
            return []
        M = np.asarray(self.vectors)
        v = M[self.vocab.index(word)]
        sim = M @ v / (np.linalg.norm(M, axis=1) * np.linalg.norm(v) + 1e-12)
        order = np.argsort(-sim)
        return [(self.vocab[i], float(sim[i])) for i in order
                if self.vocab[i] != word][:num]

    def _save_extra(self, path, arrays):
        arrays["w2v_vectors"] = np.asarray(self.vectors)

    def _load_extra(self, path, arrays):
        self.vectors = arrays["w2v_vectors"]

    def transform(self, df: DataFrame) -> DataFrame:
        index = {t: i for i, t in enumerate(self.vocab)}
        M = np.asarray(self.vectors)
        D = M.shape[1]
        out = np.zeros((df.num_rows, D), np.float64)
        for r, doc in enumerate(df[self.input_col]):
            ids = [index[t] for t in doc if t in index]
            if ids:
                out[r] = M[ids].mean(axis=0)
        return df.with_column(self.output_col, out)


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol, HasDevice):
    """Text -> feature-vector pipeline builder.

    Parity: `TextFeaturizer.scala:179` — assembles an internal pipeline of
    tokenizer → stopword remover → n-gram → HashingTF → IDF, each part
    toggleable, and fits it as one unit (the fitted result is a
    :class:`TextFeaturizerModel` wrapping the internal PipelineModel, as
    the reference wraps a Spark PipelineModel at
    `TextFeaturizer.scala:386`). ``device`` is where the Word2Vec path
    trains (the card unless ``"cpu"``); the other paths are host-side.
    """

    use_tokenizer = Param(True, "split text into tokens", ptype=bool)
    tokenizer_pattern = Param(r"\W+", "token split pattern", ptype=str)
    to_lowercase = Param(True, "lowercase text", ptype=bool)
    use_stop_words_remover = Param(False, "remove stopwords", ptype=bool)
    use_n_gram = Param(False, "use n-grams", ptype=bool)
    n_gram_length = Param(2, "n-gram length", ptype=int)
    num_features = Param(1 << 12, "hash dims", ptype=int)
    binary = Param(False, "binary TF", ptype=bool)
    use_idf = Param(True, "apply IDF scaling", ptype=bool)
    min_doc_freq = Param(1, "IDF min document frequency", ptype=int)
    use_word2vec = Param(False, "embed via Word2Vec instead of TF(IDF)",
                         ptype=bool)
    word2vec_size = Param(32, "Word2Vec dimension", ptype=int)

    def fit(self, df: DataFrame) -> "TextFeaturizerModel":
        col = self.input_col
        out = self.output_col or f"{col}_features"
        stages: List[Any] = []
        cur = f"{col}__tokens"
        if self.use_tokenizer:
            stages.append(Tokenizer(
                input_col=col, output_col=cur,
                pattern=self.tokenizer_pattern,
                to_lowercase=self.to_lowercase))
        else:
            cur = col
        if self.use_stop_words_remover:
            nxt = f"{col}__nostop"
            stages.append(StopWordsRemover(input_col=cur, output_col=nxt))
            cur = nxt
        if self.use_n_gram:
            nxt = f"{col}__ngrams"
            stages.append(NGram(input_col=cur, output_col=nxt,
                                n=self.n_gram_length))
            cur = nxt
        if self.use_word2vec:
            stages.append(Word2Vec(input_col=cur, output_col=out,
                                   vector_size=self.word2vec_size,
                                   device=self.device))
        else:
            tf_col = out if not self.use_idf else f"{col}__tf"
            stages.append(HashingTF(input_col=cur, output_col=tf_col,
                                    num_features=self.num_features,
                                    binary=self.binary))
            if self.use_idf:
                stages.append(IDF(input_col=tf_col, output_col=out,
                                  min_doc_freq=self.min_doc_freq))
        fitted = Pipeline(stages=stages).fit(df)
        return TextFeaturizerModel(input_col=col, output_col=out,
                                   model=fitted)


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    """Parity: `TextFeaturizer.scala:386` (fitted pipeline wrapper)."""

    model = Param(None, "fitted internal pipeline", complex=True)

    def transform(self, df: DataFrame) -> DataFrame:
        out = self.model.transform(df)
        drop = [c for c in out.columns
                if c.startswith(f"{self.input_col}__")]
        return out.drop(*drop)

    def _save_extra(self, path, arrays):
        import os
        self.model.save(os.path.join(path, "inner"))

    def _load_extra(self, path, arrays):
        import os
        from mmlspark_tpu_torch.core.stage import PipelineStage
        self.model = PipelineStage.load(os.path.join(path, "inner"))


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split long documents into bounded-length pages.

    Parity: `PageSplitter.scala:19` — pages of at most
    ``maximum_page_length`` characters, preferring to break at whitespace
    after ``minimum_page_length``.
    """

    maximum_page_length = Param(5000, "max page chars", ptype=int)
    minimum_page_length = Param(4500, "min chars before a soft break",
                                ptype=int)
    boundary_regex = Param(r"\s", "soft break pattern", ptype=str)

    def transform(self, df: DataFrame) -> DataFrame:
        lo, hi = self.minimum_page_length, self.maximum_page_length
        boundary = re.compile(self.boundary_regex)
        out: List[List[str]] = []
        for text in df[self.input_col]:
            s = str(text)
            pages: List[str] = []
            while len(s) > hi:
                cut = -1
                for m in boundary.finditer(s, lo, hi):
                    if m.start() > 0:  # a cut at 0 would make an empty page
                        cut = m.start()
                        break
                if cut < 0:
                    cut = hi
                pages.append(s[:cut])
                s = s[cut:]
            if s:
                pages.append(s)
            out.append(pages)
        return df.with_column(self.output_col, _obj_col(out))
