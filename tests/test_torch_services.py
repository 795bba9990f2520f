"""The port's Cognitive Services clients and batch writers
(``mmlspark_tpu_torch/io/services.py``) against the JAX package's, on
the CPU.

Every service runs in both packages against one localhost recorder
(``tests/test_torch_http.py``'s): the requests it receives (method,
path and query, body, content type, key headers) must be equal, and so
must the shaped output and error columns. Canned replies hold each text
service's response shaping; a paging server holds ``BingImageSource``;
the writers' batches are the bodies the server received.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JDF
from mmlspark_tpu.io import services as JS
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.io import services as PS

from test_torch_http import _cells, server  # noqa: F401  (a fixture)

torch.set_num_threads(1)

PACKAGES = (("jax", JS, JDF), ("port", PS, DataFrame))


def _both(handler, make, columns):
    """Run ``make(module).transform(frame(columns))`` in each package;
    return the outputs and the requests the server received."""
    outs, sent = {}, {}
    for name, mod, frame in PACKAGES:
        handler.received.clear()
        outs[name] = make(mod).transform(frame(dict(columns)))
        sent[name] = sorted(handler.received,
                            key=lambda r: (r["path"], r["body"]))
    assert sent["port"] == sent["jax"]
    assert _cells(outs["port"]) == _cells(outs["jax"])
    return outs["port"], sent["port"]


TEXT_SERVICES = ("TextSentiment", "LanguageDetector", "EntityDetector",
                 "NER", "KeyPhraseExtractor")
IMAGE_SERVICES = ("AnalyzeImage", "OCR", "DescribeImage", "TagImage")


@pytest.mark.parametrize("name", TEXT_SERVICES)
def test_text_service_protocol(server, name):
    url, handler = server
    out, sent = _both(handler, lambda m: getattr(m, name)(
        url=url + "/text", subscription_key="k", language="en",
        concurrency=2), {"text": ["great product", None, "meh"]})
    assert len(sent) == 2
    doc = json.loads(sent[0]["body"])["documents"][0]
    assert doc["language"] == "en" and doc["id"] == "0"
    assert sent[0]["key"] == "k"
    assert sent[0]["content_type"] == "application/json"
    assert out["result"][1] is None and out["error"][1] is None


CANNED = {
    "TextSentiment": ({"documents": [{"id": "0", "score": 0.93}],
                       "errors": []}, 0.93),
    "LanguageDetector": ({"documents": [{"id": "0", "detectedLanguages": [
        {"name": "French", "iso6391Name": "fr", "score": 0.2},
        {"name": "English", "iso6391Name": "en", "score": 0.8}]}]},
        {"language": "English", "iso6391Name": "en", "score": 0.8,
         "detectedLanguages": [
             {"name": "French", "iso6391Name": "fr", "score": 0.2},
             {"name": "English", "iso6391Name": "en", "score": 0.8}]}),
    "EntityDetector": ({"documents": [{"id": "0", "entities": [
        {"name": "Seattle", "wikipediaId": "Seattle",
         "matches": [{"text": "Seattle", "offset": 0, "length": 7}]}]}]},
        [{"name": "Seattle", "wikipediaId": "Seattle",
          "matches": [{"text": "Seattle", "offset": 0, "length": 7}]}]),
    "NER": ({"documents": [{"id": "0", "entities": [
        {"name": "Satya", "type": "Person", "subtype": None}]}]},
        [{"name": "Satya", "type": "Person", "subtype": None}]),
    "KeyPhraseExtractor": ({"documents": [
        {"id": "0", "keyPhrases": ["wonderful trip", "hotel"]}]},
        ["wonderful trip", "hotel"]),
}


@pytest.mark.parametrize("name", TEXT_SERVICES)
def test_text_service_shaping(server, name):
    url, handler = server
    body, want = CANNED[name]
    handler.canned = body
    out, _ = _both(handler, lambda m: getattr(m, name)(url=url),
                   {"text": ["x"]})
    assert out["result"][0] == want


@pytest.mark.parametrize("body,want", [
    ({"documents": [], "errors": [{"id": "0", "message": "bad language"}]},
     {"error": "bad language"}),
    ({"documents": []}, None),
    ([1, 2], None),
    ({"documents": [{"id": "0"}]}, None),
])
def test_text_service_errors_and_odd_bodies(server, body, want):
    url, handler = server
    handler.canned = body
    out, _ = _both(handler, lambda m: m.TextSentiment(url=url),
                   {"text": ["x"]})
    assert out["result"][0] == want


@pytest.mark.parametrize("name", IMAGE_SERVICES)
def test_image_service_protocol(server, name):
    url, handler = server
    out, sent = _both(handler, lambda m: getattr(m, name)(
        url=url + "/vision", subscription_key="s"),
        {"image_url": ["http://x/im.jpg", None]})
    assert json.loads(sent[0]["body"]) == {"url": "http://x/im.jpg"}
    assert out["result"][0]["echo"] == {"url": "http://x/im.jpg"}
    assert out["result"][1] is None


@pytest.mark.parametrize("make,path_has", [
    (lambda m, u: m.GenerateThumbnails(url=u, width=32, height=16,
                                       smart_cropping=False),
     "width=32&height=16&smartCropping=false"),
    (lambda m, u: m.GenerateThumbnails(url=u + "?v=1"), "?v=1&width=64"),
    (lambda m, u: m.RecognizeText(url=u, mode="Handwritten"),
     "mode=Handwritten"),
    (lambda m, u: m.RecognizeDomainSpecificContent(url=u + "/", model=
                                                   "landmarks"),
     "/models/landmarks/analyze"),
    (lambda m, u: m.DetectFace(url=u, return_face_attributes=["age",
                                                             "gender"]),
     "returnFaceId=true&returnFaceLandmarks=false"
     "&returnFaceAttributes=age,gender"),
    (lambda m, u: m.DetectFace(url=u, return_face_id=False,
                               return_face_landmarks=True),
     "returnFaceId=false&returnFaceLandmarks=true"),
])
def test_vision_query_params(server, make, path_has):
    url, handler = server
    out, sent = _both(handler, lambda m: make(m, url),
                      {"image_url": ["http://x/a.png"]})
    assert path_has in sent[0]["path"]
    assert path_has in out["result"][0]["path"]


def test_face_suite_protocols(server):
    url, handler = server
    out, sent = _both(handler, lambda m: m.FindSimilarFace(
        url=url, face_ids=["a", "b"], max_candidates=3),
        {"face_id": ["probe", None]})
    assert json.loads(sent[0]["body"]) == {
        "faceId": "probe", "faceIds": ["a", "b"],
        "maxNumOfCandidatesReturned": 3}
    ids = np.empty(3, dtype=object)
    ids[:] = [["f1", "f2"], np.array(["f3"]), None]
    out, sent = _both(handler, lambda m: m.GroupFaces(url=url),
                      {"face_ids": ids})
    assert [json.loads(r["body"]) for r in sent] == [
        {"faceIds": ["f1", "f2"]}, {"faceIds": ["f3"]}]
    assert out["result"][2] is None
    out, sent = _both(handler, lambda m: m.IdentifyFaces(
        url=url, person_group_id="g", max_candidates=2), {"face_ids": ids})
    assert json.loads(sent[0]["body"])["personGroupId"] == "g"
    out, sent = _both(handler, lambda m: m.VerifyFaces(url=url), {
        "face_id1": ["x", None, "p"], "face_id2": ["y", "z", None]})
    assert len(sent) == 1
    assert out["result"][0]["faceId1"] == "x"
    assert out["result"][1] is None and out["result"][2] is None
    assert "__verify_pair__" not in out.columns


def test_speech_to_text_binary_body(server):
    url, handler = server
    audio = bytes(range(64))
    out, sent = _both(handler, lambda m: m.SpeechToText(
        url=url + "/speech", language="de-DE", audio_format="ogg",
        subscription_key="k"), {"audio": [audio, None]})
    assert sent[0]["body"] == audio
    assert sent[0]["content_type"] == "audio/ogg"
    assert sent[0]["path"] == "/speech?language=de-DE"
    assert out["result"][0]["echo"] == {"raw_len": 64,
                                        "content_type": "audio/ogg"}


def test_bing_image_search_get(server):
    url, handler = server
    out, sent = _both(handler, lambda m: m.BingImageSearch(
        url=url + "/search", count=3, offset=6),
        {"query": ["tpu chips", None]})
    assert sent[0]["method"] == "GET"
    assert sent[0]["path"] == "/search?q=tpu%20chips&count=3&offset=6"
    assert out["result"][0] == [{"name": "hit"}]


def test_detect_anomalies(server):
    url, handler = server
    series = [{"timestamp": "2020-01-01", "value": 1.0},
              {"timestamp": "2020-01-02", "value": 9.0}]
    col = np.empty(3, dtype=object)
    col[:] = [series, np.array(series, dtype=object), None]
    out, sent = _both(handler, lambda m: m.DetectAnomalies(
        url=url, granularity="hourly"), {"series": col})
    assert json.loads(sent[0]["body"]) == {"series": series,
                                           "granularity": "hourly"}
    assert out["result"][0]["echo"]["granularity"] == "hourly"
    assert out["result"][2] is None


def test_refused_rows_land_in_the_error_column(server):
    url, handler = server
    out, _ = _both(handler, lambda m: m.DetectAnomalies(
        url=url + "/missing", handler="basic"), {"series": [[{"v": 1}]]})
    assert out["result"][0] is None
    assert out["error"][0] == {"status_code": 404, "reason": "Not Found"}


def _writer_frame(frame, n=250, fail_at=None):
    cols = {"a": np.arange(n), "b": np.arange(n) * 1.5,
            "s": [f"r{i}" for i in range(n)]}
    if fail_at is not None:
        cols["fail"] = (np.arange(n) == fail_at).astype(np.int64)
    return frame(cols)


def _write_both(handler, make, **kw):
    errs, sent = {}, {}
    for name, mod, frame in PACKAGES:
        handler.received.clear()
        errs[name] = make(mod).write(_writer_frame(frame, **kw))
        sent[name] = sorted(handler.received, key=lambda r: r["body"])
    assert sent["port"] == sent["jax"]
    assert errs["port"] == errs["jax"]
    return errs["port"], sent["port"]


def test_powerbi_writer_batches(server):
    url, handler = server
    errs, sent = _write_both(handler, lambda m: m.PowerBIWriter(
        url + "/pbi", batch_size=100))
    assert errs == []
    batches = sorted((json.loads(r["body"]) for r in sent),
                     key=lambda b: b[0]["a"])
    assert [len(b) for b in batches] == [100, 100, 50]
    assert batches[2][-1] == {"a": 249, "b": 373.5, "s": "r249"}


def test_azure_search_writer_batches(server):
    url, handler = server
    errs, sent = _write_both(handler, lambda m: m.AzureSearchWriter(
        url + "/index", action="upload", key="k", batch_size=64),
        n=130)
    assert errs == []
    assert all(r["api_key"] == "k" for r in sent)
    batches = sorted((json.loads(r["body"])["value"] for r in sent),
                     key=lambda b: b[0]["a"])
    assert [len(b) for b in batches] == [64, 64, 2]
    assert batches[0][0] == {"a": 0, "b": 0.0, "s": "r0",
                             "@search.action": "upload"}


def test_writers_report_failed_batches(server):
    """The batch holding a refused row is retried under the policy and
    then reported, with its index, status and reason."""
    url, handler = server
    errs, _ = _write_both(handler, lambda m: m.PowerBIWriter(
        url + "/pbi", batch_size=10), n=30, fail_at=15)
    assert errs == [{"batch": 1, "status_code": 500,
                     "reason": "Internal Server Error"}]
    errs, _ = _write_both(handler, lambda m: m.AzureSearchWriter(
        url + "/missing", batch_size=20), n=30)
    assert errs == [{"batch": i, "status_code": 404, "reason": "Not Found"}
                    for i in range(2)]


@pytest.fixture
def paging_server():
    """Serves 2 pages of image results per query, then empty; a query
    ``bad`` gets a 500."""
    class Handler(BaseHTTPRequestHandler):
        offsets = []

        def do_GET(self):
            q = parse_qs(urlparse(self.path).query)
            offset = int(q.get("offset", ["0"])[0])
            count = int(q.get("count", ["10"])[0])
            term = q.get("q", [""])[0]
            type(self).offsets.append((term, offset))
            if term == "bad":
                self.send_error(500, "boom")
                return
            value = ([{"name": f"{term}-{offset + i}",
                       "contentUrl": f"http://img/{term}/{offset + i}"}
                      for i in range(count)]
                     if offset < 2 * count else [])
            body = json.dumps({"value": value}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", Handler
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("max_batches", [None, 1])
def test_bing_image_source_pages(paging_server, max_batches):
    url, handler = paging_server
    frames, asked = {}, {}
    for name, mod, _ in PACKAGES:
        handler.offsets.clear()
        src = mod.BingImageSource(["cats", "dogs"], url=url,
                                  imgs_per_batch=3)
        frames[name] = [_cells(f) for f in src.batches(max_batches)]
        asked[name] = sorted(handler.offsets)
    assert frames["port"] == frames["jax"]
    assert asked["port"] == asked["jax"]
    assert len(frames["port"]) == (2 if max_batches is None else 1)
    for f in frames["port"]:
        assert len(f["image"]) == 6
        assert set(f["search_term"]) == {"cats", "dogs"}


def test_bing_image_source_partial_failure_raises(paging_server):
    url, _ = paging_server
    for _, mod, _ in PACKAGES:
        src = mod.BingImageSource(["ok", "bad"], url=url + "/images",
                                  imgs_per_batch=2)
        with pytest.raises(IOError, match="1/2 terms"):
            list(src.batches())
    with pytest.raises(ValueError):
        PS.BingImageSource([], url=url)


SERVICES = TEXT_SERVICES + IMAGE_SERVICES + (
    "GenerateThumbnails", "RecognizeText", "RecognizeDomainSpecificContent",
    "DetectFace", "FindSimilarFace", "GroupFaces", "IdentifyFaces",
    "VerifyFaces", "SpeechToText", "BingImageSearch", "DetectAnomalies",
    "CognitiveServiceBase")


@pytest.mark.parametrize("name", SERVICES)
def test_services_keep_jaxs_params(name):
    j, p = getattr(JS, name), getattr(PS, name)
    assert sorted(p.params()) == sorted(j.params())
    for k, param in j.params().items():
        assert p.params()[k].default == param.default, k
