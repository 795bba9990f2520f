"""Cognitive-service-style transformers + PowerBI-style writer (the
port's copy of ``mmlspark_tpu/io/services.py``; host code, no device).

Capability parity with the reference's Cognitive Services layer
(`io/http/src/main/scala/CognitiveServiceBase.scala:25-241`,
`services/TextAnalytics.scala:184-248`, `services/ComputerVision.scala:180-474`,
`services/Face.scala:19-277`, `services/Speech.scala:23`,
`services/ImageSearch.scala:63`, `services/AzureSearch.scala:81,143`,
`services/AnamolyDetection.scala:118,131`) and the PowerBI writer
(`io/powerbi/src/main/scala/PowerBIWriter.scala:25`): text analytics,
computer vision, face, speech, anomaly detection, image search, plus the
two batch writers. Every stage takes an explicit ``url`` so they run
against any compatible endpoint (tests use localhost) rather than
hard-coding Azure regions.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, obj_col
from mmlspark_tpu_torch.core.params import Param, HasOutputCol, in_range
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.io.http import (
    CustomInputParser, HTTPRequestData, JSONOutputParser,
    SimpleHTTPTransformer,
)


class CognitiveServiceBase(Transformer, HasOutputCol):
    """Shared plumbing: build a JSON request per row, send, parse.

    Parity: `CognitiveServiceBase.scala:25-241` (HasServiceParams /
    subscription key header / SimpleHTTPTransformer internals).
    """

    url = Param(None, "service endpoint", ptype=str)
    subscription_key = Param(None, "subscription key header value")
    concurrency = Param(4, "max in-flight requests", in_range(lo=1))
    timeout = Param(60.0, "request timeout, s", in_range(lo=0.0))
    error_col = Param("error", "failed-request info column")
    output_col = Param("result", "parsed output column")
    # policy-driven by default: jittered/budgeted retries + a per-host
    # circuit breaker, so a dead or throttling service endpoint sheds
    # the rest of the frame instead of timing out row by row
    handler = Param("policy", "retry policy: basic|advanced|policy")
    budget = Param(None, "optional whole-transform deadline, seconds",
                   ptype=float)

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.subscription_key:
            h["Ocp-Apim-Subscription-Key"] = self.subscription_key
        return h

    def _make_request(self, value: Any) -> Optional[HTTPRequestData]:
        """Row value -> request; override per service."""
        raise NotImplementedError

    def _input_column(self) -> str:
        raise NotImplementedError

    def _output_parser(self) -> Transformer:
        return JSONOutputParser()

    def transform(self, df: DataFrame) -> DataFrame:
        inner = SimpleHTTPTransformer(
            input_col=self._input_column(), output_col=self.output_col,
            input_parser=CustomInputParser(udf=self._make_request),
            output_parser=self._output_parser(),
            error_col=self.error_col, concurrency=self.concurrency,
            timeout=self.timeout, handler=self.handler,
            budget=self.budget)
        return inner.transform(df)


class _TextAnalyticsBase(CognitiveServiceBase):
    """Documents-array protocol shared by the text services.

    Parity: TextAnalyticsBase (`TextAnalytics.scala`): rows become
    ``{"documents": [{"id", "text", "language"?}]}`` requests.
    """

    text_col = Param("text", "input text column")
    language = Param(None, "language hint")

    def _input_column(self) -> str:
        return self.text_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        doc: Dict[str, Any] = {"id": "0", "text": str(value)}
        if self.language:
            doc["language"] = self.language
        return HTTPRequestData.post_json(
            self.url, {"documents": [doc]}, self._headers())

    def _shape_doc(self, doc: Dict[str, Any]) -> Any:
        """Per-service payload extraction from a response document;
        subclasses each mirror their reference response schema
        (`schemas/TextAnalyticsSchemas.scala`)."""
        return doc

    def _output_parser(self) -> Transformer:
        from mmlspark_tpu_torch.io.http import CustomOutputParser

        def parse(resp):
            try:
                body = resp.json()
            except (ValueError, AttributeError):
                return None
            if not isinstance(body, dict):
                return None
            docs = body.get("documents") or []
            if not docs:
                # TAResponse.errors: surface the per-document message
                errs = body.get("errors") or []
                if errs and isinstance(errs[0], dict):
                    return {"error": errs[0].get("message", "")}
                return None
            return self._shape_doc(docs[0])

        return CustomOutputParser(udf=parse)


class TextSentiment(_TextAnalyticsBase):
    """Sentiment score in [0, 1] per row (0 = negative, 1 = positive).

    Output column holds the float score alone — the distinct
    ``SentimentScore(id, score)`` schema of the reference
    (`TextAnalytics.scala:184`, `TextAnalyticsSchemas.scala`
    SentimentResponse).
    """

    def _shape_doc(self, doc: Dict[str, Any]) -> Any:
        return doc.get("score")


class LanguageDetector(_TextAnalyticsBase):
    """Detected language per row: best guess + full candidate list.

    Output: ``{"language", "iso6391Name", "score", "detectedLanguages"}``
    (reference `DetectLanguageScore.detectedLanguages` with
    ``DetectedLanguage(name, iso6391Name, score)``).
    """

    def _shape_doc(self, doc: Dict[str, Any]) -> Any:
        langs = doc.get("detectedLanguages") or []
        best = max(langs, key=lambda d: d.get("score", 0.0)) if langs else {}
        return {"language": best.get("name"),
                "iso6391Name": best.get("iso6391Name"),
                "score": best.get("score"),
                "detectedLanguages": langs}


class EntityDetector(_TextAnalyticsBase):
    """Linked (wikipedia) entities per row.

    Output: the ``entities`` list — reference ``Entity(name, matches,
    wikipediaLanguage, wikipediaId, wikipediaUrl, bingId)``
    (DetectEntitiesResponse).
    """

    def _shape_doc(self, doc: Dict[str, Any]) -> Any:
        return doc.get("entities") or []


class NER(_TextAnalyticsBase):
    """Named entities with type/subtype per row.

    Output: the ``entities`` list — reference ``NEREntity(name, matches,
    type, subtype, ...)`` (NERResponse); distinct from
    :class:`EntityDetector`'s wikipedia-linking schema.
    """

    def _shape_doc(self, doc: Dict[str, Any]) -> Any:
        return doc.get("entities") or []


class KeyPhraseExtractor(_TextAnalyticsBase):
    """Key phrases per row as a list of strings.

    Output: ``keyPhrases`` (reference ``KeyPhraseScore.keyPhrases``,
    KeyPhraseResponse).
    """

    def _shape_doc(self, doc: Dict[str, Any]) -> Any:
        return doc.get("keyPhrases") or []


class _ImageServiceBase(CognitiveServiceBase):
    """Image-url protocol shared by the vision services."""

    image_url_col = Param("image_url", "column of image URLs")

    def _input_column(self) -> str:
        return self.image_url_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        return HTTPRequestData.post_json(
            self.url, {"url": str(value)}, self._headers())


class AnalyzeImage(_ImageServiceBase):
    """Parity: `ComputerVision.scala` AnalyzeImage."""


class OCR(_ImageServiceBase):
    """Parity: `ComputerVision.scala` OCR."""


class DescribeImage(_ImageServiceBase):
    """Parity: `ComputerVision.scala` DescribeImage."""


class TagImage(_ImageServiceBase):
    """Parity: `ComputerVision.scala` TagImage."""


class GenerateThumbnails(_ImageServiceBase):
    """Parity: `ComputerVision.scala` GenerateThumbnails (width/height/
    smartCropping as query params)."""

    width = Param(64, "thumbnail width", ptype=int)
    height = Param(64, "thumbnail height", ptype=int)
    smart_cropping = Param(True, "crop around region of interest",
                           ptype=bool)

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        q = (f"width={self.width}&height={self.height}"
             f"&smartCropping={str(self.smart_cropping).lower()}")
        sep = "&" if "?" in self.url else "?"
        return HTTPRequestData.post_json(
            f"{self.url}{sep}{q}", {"url": str(value)}, self._headers())


class RecognizeText(_ImageServiceBase):
    """Parity: `ComputerVision.scala` RecognizeText (mode query param)."""

    mode = Param("Printed", "Printed | Handwritten")

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        sep = "&" if "?" in self.url else "?"
        return HTTPRequestData.post_json(
            f"{self.url}{sep}mode={self.mode}", {"url": str(value)},
            self._headers())


class RecognizeDomainSpecificContent(_ImageServiceBase):
    """Parity: `ComputerVision.scala` RecognizeDomainSpecificContent
    (celebrity/landmark model in the path)."""

    model = Param("celebrities", "domain model name")

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        return HTTPRequestData.post_json(
            f"{self.url.rstrip('/')}/models/{self.model}/analyze",
            {"url": str(value)}, self._headers())


class DetectFace(_ImageServiceBase):
    """Parity: `Face.scala:19` DetectFace (returnFaceAttributes etc.)."""

    return_face_id = Param(True, "include faceId", ptype=bool)
    return_face_landmarks = Param(False, "include landmarks", ptype=bool)
    return_face_attributes = Param(None, "attribute list", ptype=list)

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        q = [f"returnFaceId={str(self.return_face_id).lower()}",
             f"returnFaceLandmarks={str(self.return_face_landmarks).lower()}"]
        if self.return_face_attributes:
            q.append("returnFaceAttributes="
                     + ",".join(self.return_face_attributes))
        sep = "&" if "?" in self.url else "?"
        return HTTPRequestData.post_json(
            f"{self.url}{sep}{'&'.join(q)}", {"url": str(value)},
            self._headers())


class FindSimilarFace(CognitiveServiceBase):
    """Parity: `Face.scala` FindSimilarFaces: one probe faceId per row
    against a fixed candidate list."""

    face_id_col = Param("face_id", "column of probe face ids")
    face_ids = Param(None, "candidate face ids", ptype=list)
    max_candidates = Param(20, "max returned matches", ptype=int)

    def _input_column(self) -> str:
        return self.face_id_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        return HTTPRequestData.post_json(
            self.url, {"faceId": str(value),
                       "faceIds": list(self.face_ids or []),
                       "maxNumOfCandidatesReturned": self.max_candidates},
            self._headers())


class GroupFaces(CognitiveServiceBase):
    """Parity: `Face.scala` GroupFaces: each row holds a faceIds list."""

    face_ids_col = Param("face_ids", "column of face-id lists")

    def _input_column(self) -> str:
        return self.face_ids_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        ids = value.tolist() if isinstance(value, np.ndarray) else list(value)
        return HTTPRequestData.post_json(
            self.url, {"faceIds": [str(v) for v in ids]}, self._headers())


class IdentifyFaces(GroupFaces):
    """Parity: `Face.scala` IdentifyFaces (faceIds + personGroupId)."""

    person_group_id = Param(None, "person group to search")
    max_candidates = Param(1, "candidates per face", ptype=int)

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        ids = value.tolist() if isinstance(value, np.ndarray) else list(value)
        return HTTPRequestData.post_json(
            self.url, {"faceIds": [str(v) for v in ids],
                       "personGroupId": self.person_group_id,
                       "maxNumOfCandidatesReturned": self.max_candidates},
            self._headers())


class VerifyFaces(CognitiveServiceBase):
    """Parity: `Face.scala` VerifyFaces — two face-id columns per row."""

    face_id1_col = Param("face_id1", "first face id column")
    face_id2_col = Param("face_id2", "second face id column")

    def _input_column(self) -> str:
        return "__verify_pair__"

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        f1, f2 = value
        if f1 is None or f2 is None:  # null skip, like every other binding
            return None
        return HTTPRequestData.post_json(
            self.url, {"faceId1": str(f1), "faceId2": str(f2)},
            self._headers())

    def transform(self, df: DataFrame) -> DataFrame:
        pairs = obj_col(list(zip(df[self.face_id1_col],
                                 df[self.face_id2_col])))
        out = super().transform(df.with_column("__verify_pair__", pairs))
        return out.drop("__verify_pair__")


class SpeechToText(CognitiveServiceBase):
    """Parity: `Speech.scala:23` SpeechToText — posts raw audio bytes."""

    audio_col = Param("audio", "column of raw audio bytes")
    audio_format = Param("wav", "audio container format")
    language = Param("en-US", "recognition language")

    def _input_column(self) -> str:
        return self.audio_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        h = self._headers()
        h["Content-Type"] = f"audio/{self.audio_format}"
        sep = "&" if "?" in self.url else "?"
        return HTTPRequestData(url=f"{self.url}{sep}language={self.language}",
                               method="POST", headers=h, body=bytes(value))


class BingImageSearch(CognitiveServiceBase):
    """Parity: `ImageSearch.scala:63` BingImageSearch — GET per query row;
    results land under the response's ``value`` array."""

    query_col = Param("query", "column of search queries")
    count = Param(10, "results per query", ptype=int)
    offset = Param(0, "result offset", ptype=int)

    def _input_column(self) -> str:
        return self.query_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        from urllib.parse import quote
        sep = "&" if "?" in self.url else "?"
        return HTTPRequestData(
            url=(f"{self.url}{sep}q={quote(str(value))}"
                 f"&count={self.count}&offset={self.offset}"),
            method="GET", headers=self._headers())

    def _output_parser(self) -> Transformer:
        return JSONOutputParser(data_field="value")


class BingImageSource:
    """Streaming image-search source: page through results for a set of
    search terms, one frame of ``(search_term, image)`` rows per batch.

    Parity: `BingImageSource.scala:83` — the reference pairs a counting
    streaming source with a vector-param BingImageSearch and explodes
    each response's image array; here each :meth:`batches` step queries
    every term at the current offset through :class:`BingImageSearch`,
    explodes the ``value`` arrays into rows, and advances the offset by
    ``imgs_per_batch``. The stream ends when every term comes back
    empty (results exhausted), mirroring `FileStreamSource.batches`.
    """

    def __init__(self, search_terms: List[str], url: str,
                 subscription_key: Optional[str] = None,
                 imgs_per_batch: int = 10,
                 concurrency: int = 4,
                 timeout: float = 60.0):
        if not search_terms:
            raise ValueError("search_terms must be non-empty")
        self.search_terms = list(search_terms)
        self.url = url
        self.subscription_key = subscription_key
        self.imgs_per_batch = int(imgs_per_batch)
        self.concurrency = concurrency
        self.timeout = timeout
        self._offset = 0

    def batches(self, max_batches: Optional[int] = None):
        """Yield frames of ``search_term`` / ``image`` (one row per image
        object) until exhausted or ``max_batches``."""
        yielded = 0
        while max_batches is None or yielded < max_batches:
            stage = BingImageSearch(
                url=self.url, subscription_key=self.subscription_key,
                count=self.imgs_per_batch, offset=self._offset,
                concurrency=self.concurrency, timeout=self.timeout)
            out = stage.transform(
                DataFrame({"query": np.array(self.search_terms,
                                             dtype=object)}))
            terms: List[str] = []
            images: List[Any] = []
            for term, imgs in zip(out["query"], out["result"]):
                for img in imgs or []:
                    terms.append(str(term))
                    images.append(img)
            if not terms:
                # empty page != failed page: exhaustion is only when every
                # term came back empty WITHOUT error. Any errored term on a
                # zero-row page means remaining pages may exist — raise
                # rather than silently dropping them (partial outages
                # previously masqueraded as end-of-stream).
                errs = [e for e in out[stage.error_col] if e is not None]
                if errs:
                    raise IOError(
                        f"image-search batch failed for {len(errs)}/"
                        f"{len(self.search_terms)} terms at offset "
                        f"{self._offset}: {errs[0]}")
                return
            self._offset += self.imgs_per_batch
            yielded += 1
            yield DataFrame({"search_term": np.array(terms, dtype=object),
                             "image": obj_col(images)})


def _post_batches(url: str, payloads: List[Any],
                  headers: Optional[Dict[str, str]] = None,
                  concurrency: int = 2,
                  timeout: float = 30.0) -> List[Dict[str, Any]]:
    """POST each payload (policy-driven: jittered retries with budget +
    per-host circuit breaking); returns the per-batch error dicts shared
    by the batch writers."""
    from mmlspark_tpu_torch.core.resilience import RetryPolicy
    from mmlspark_tpu_torch.io.http import HTTPClient

    reqs = [HTTPRequestData.post_json(url, p, headers) for p in payloads]
    client = HTTPClient(concurrency=concurrency, timeout=timeout,
                        policy=RetryPolicy(), breakers=True)
    try:
        resps = client.send(reqs)
    finally:
        client.close()
    return [{"batch": i, "status_code": getattr(r, "status_code", 0),
             "reason": getattr(r, "reason", "no response")}
            for i, r in enumerate(resps)
            if r is None or not (200 <= r.status_code < 300)]


class AzureSearchWriter:
    """Batch-POST rows as index actions (parity: `AzureSearch.scala:81,143`
    — rows wrapped as ``{"value": [{"@search.action": ...}, ...]}``)."""

    def __init__(self, url: str, action: str = "mergeOrUpload",
                 key: Optional[str] = None, batch_size: int = 100,
                 concurrency: int = 2, timeout: float = 30.0):
        self.url = url
        self.action = action
        self.key = key
        self.batch_size = int(batch_size)
        self.concurrency = concurrency
        self.timeout = timeout

    def write(self, df: DataFrame) -> List[Dict[str, Any]]:
        from mmlspark_tpu_torch.core.serialize import _jsonify
        headers = {"Content-Type": "application/json"}
        if self.key:
            headers["api-key"] = self.key
        rows = [dict(_jsonify(row), **{"@search.action": self.action})
                for row in df.rows()]
        payloads = [{"value": rows[s:s + self.batch_size]}
                    for s in range(0, len(rows), self.batch_size)]
        return _post_batches(self.url, payloads, headers,
                             self.concurrency, self.timeout)


class DetectAnomalies(CognitiveServiceBase):
    """Series-in, anomalies-out (parity: `AnamolyDetection.scala:118`).

    The input column holds ``[{"timestamp": ..., "value": ...}, ...]``
    series per row; the request wraps it with granularity.
    """

    series_col = Param("series", "column of timestamp/value series")
    granularity = Param("daily", "series granularity")

    def _input_column(self) -> str:
        return self.series_col

    def _make_request(self, value) -> Optional[HTTPRequestData]:
        if value is None:
            return None
        if isinstance(value, np.ndarray):
            value = value.tolist()
        return HTTPRequestData.post_json(
            self.url, {"series": list(value),
                       "granularity": self.granularity}, self._headers())


class PowerBIWriter:
    """POST frame rows to a REST dataset endpoint in batches.

    Parity: `PowerBIWriter.scala:25` — rows serialized as a JSON array per
    batch with the advanced retry handler (throttling-aware).
    """

    def __init__(self, url: str, batch_size: int = 100,
                 concurrency: int = 2, timeout: float = 30.0):
        self.url = url
        self.batch_size = int(batch_size)
        self.concurrency = concurrency
        self.timeout = timeout

    def write(self, df: DataFrame) -> List[Dict[str, Any]]:
        """Send all rows; returns a list of per-batch error dicts (empty
        when everything succeeded)."""
        from mmlspark_tpu_torch.core.serialize import _jsonify

        rows = [_jsonify(row) for row in df.rows()]
        payloads = [rows[s:s + self.batch_size]
                    for s in range(0, len(rows), self.batch_size)]
        return _post_batches(self.url, payloads, None,
                             self.concurrency, self.timeout)
