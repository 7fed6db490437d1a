"""PyTorch port vs the JAX package: the front door's pure parts, case by
case, with no engine ticking and no socket.

- ``_parse_completion``: every payload of a table (good and bad prompts,
  sampling fields, types, stops, tags, priorities, stream flags) is
  accepted or refused exactly as the reference does, with the same
  request, tag and stream flag, or the same 400 message.
- ``_read_request`` (server) and ``_read_head`` (client): raw request
  and response heads, fed to a ``StreamReader``, parse to what the
  reference parses, or fail as it fails.
- ``_failure_status``: each finish reason maps to the reference's HTTP
  status.
- The launcher's flags: ``_parse_args``, ``_quotas`` and ``_sched_cfg``
  agree with the reference's launcher on each argv of a table (the
  port's extra ``--device`` aside), refusals included.
- The multi-model geometry check: the port's ``paged_cache_shape``
  equals the reference's ``jax.eval_shape`` of its pool, per config and
  pool size, without allocating a pool.
"""
import asyncio
import dataclasses
import types

import jax
import pytest

from repro.configs.base import ArchConfig as JArchConfig
from repro.launch import serve_http as jlaunch
from repro.models import build as jbuild
from repro.obs.metrics import MetricsRegistry as JMetrics
from repro.serving.http import client as jclient
from repro.serving.http import frontend as jfront
from repro.serving.multi_model import MultiModelEngine as JMM

import repro_torch.configs as TC
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import serve_http as tlaunch
from repro_torch.models import build
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_DEADLINE,
                                     FINISH_LENGTH, FINISH_STOP)
from repro_torch.serving.http import client as tclient
from repro_torch.serving.http import frontend as tfront
from repro_torch.serving.multi_model import MultiModelEngine


def _frontends():
    """(reference, port) servers over a stub engine: parsing reads only
    the metrics registry and the default model's name."""
    jf = jfront.HTTPFrontend(types.SimpleNamespace(metrics=JMetrics()),
                             default_model="tiny")
    tf = tfront.HTTPFrontend(types.SimpleNamespace(metrics=MetricsRegistry()),
                             default_model="tiny")
    return jf, tf


_PAYLOADS = [
    # accepted
    {"prompt": [5]},
    {"prompt": [5, 6, 7]},
    {"prompt": [2] * 300},
    {"model": "tiny", "prompt": [1, 2]},
    {"model": "other", "prompt": [1, 2]},
    {"model": 7, "prompt": [1, 2]},
    {"prompt": [3, 4], "stream": True},
    {"prompt": [3, 4], "stream": 0},
    {"prompt": [3, 4], "priority": 3},
    {"prompt": [3, 4], "priority": "2"},
    {"prompt": [3, 4], "temperature": 0.7, "top_p": 0.9, "seed": 11},
    {"prompt": [3, 4], "temperature": "0.5"},
    {"prompt": [3, 4], "top_k": 5, "min_p": 0.05},
    {"prompt": [3, 4], "max_tokens": 1},
    {"prompt": [3, 4], "max_tokens": "4"},
    {"prompt": [3, 4], "logprobs": 0},
    {"prompt": [3, 4], "logprobs": 3},
    {"prompt": [3, 4], "stop": [[7, 8], [9]]},
    {"prompt": [3, 4], "stop": None},
    {"prompt": [3, 4], "stop": []},
    {"prompt": [3, 4], "seed": None},
    {"prompt": [3, 4], "unknown_field": {"x": 1}},
    # refused: the body
    b"{not json",
    b"\xff\xfe",
    b"",
    [1, 2, 3],
    "just a string",
    # refused: the prompt
    {},
    {"prompt": []},
    {"prompt": "text"},
    {"prompt": [1, "2"]},
    {"prompt": [1, 2.5]},
    {"prompt": [[1, 2]]},
    # refused: the sampling fields
    {"prompt": [3, 4], "temperature": -1.0},
    {"prompt": [3, 4], "temperature": "hot"},
    {"prompt": [3, 4], "top_p": 0.0},
    {"prompt": [3, 4], "top_k": -2},
    {"prompt": [3, 4], "min_p": 1.5},
    {"prompt": [3, 4], "max_tokens": 0},
    {"prompt": [3, 4], "logprobs": -1},
    {"prompt": [3, 4], "seed": "abc"},
]


def _body(payload):
    if isinstance(payload, bytes):
        return payload
    return jfront._json_bytes(payload)


def _parse(front, body):
    try:
        req, tag, stream = front._parse_completion(body)
    except Exception as e:          # noqa: BLE001 - compared across ports
        return ("refused", type(e).__name__, str(e))
    return ("accepted", tag, stream, req.uid, req.priority,
            req.prompt.tolist(), str(req.prompt.dtype),
            dataclasses.asdict(req.sampling))


@pytest.mark.parametrize("payload", _PAYLOADS,
                         ids=[f"p{i}" for i in range(len(_PAYLOADS))])
def test_parse_completion_matches_reference(payload):
    jf, tf = _frontends()
    want = _parse(jf, _body(payload))
    got = _parse(tf, _body(payload))
    assert got == want
    if got[0] == "refused":
        assert got[1] == "_BadRequest"


_RAW_REQUESTS = [
    b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n",
    b"get /v1/models HTTP/1.1\r\n\r\n",
    b"POST /v1/completions HTTP/1.1\r\nContent-Length: 2\r\n\r\n{}",
    b"POST /v1/completions?x=1 HTTP/1.1\r\nCONTENT-LENGTH: 4\r\n\r\nabcd",
    b"POST /a HTTP/1.1\r\nContent-Length:   3  \r\nX-Y: z:w\r\n\r\nabc",
    b"POST /a HTTP/1.1\nContent-Length: 1\n\nq",
    b"POST /a HTTP/1.1\r\nContent-Length: \r\n\r\n",
    b"GET / HTTP/1.1\r\nHost: x\r\n",
    b"",
    b"GARBAGE\r\n\r\n",
    b"\r\n",
    b"POST /a HTTP/1.1\r\nContent-Length: 5\r\n\r\nab",
    b"POST /a HTTP/1.1\r\nContent-Length: 99999999\r\n\r\n",
    b"POST /a HTTP/1.1\r\nContent-Length: many\r\n\r\n",
]


def _read(coro_fn, raw, *args):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            return ("ok", await coro_fn(reader, *args))
        except Exception as e:      # noqa: BLE001 - compared across ports
            return ("error", type(e).__name__, str(e))
    return asyncio.run(asyncio.wait_for(go(), 10))


@pytest.mark.parametrize("raw", _RAW_REQUESTS,
                         ids=[f"r{i}" for i in range(len(_RAW_REQUESTS))])
def test_read_request_matches_reference(raw):
    want = _read(jfront.HTTPFrontend._read_request, raw)
    got = _read(tfront.HTTPFrontend._read_request, raw)
    assert got == want


_RAW_HEADS = [
    b"HTTP/1.1 200 OK\r\nContent-Type: application/json\r\n\r\n{}",
    b"HTTP/1.1 429 Too Many Requests\r\nRetry-After: 1\r\n\r\n",
    b"HTTP/1.1 504 Gateway Timeout\r\n\r\n",
    b"HTTP/1.0 404\r\n\r\n",
    b"HTTP/1.1 200 OK\nX-A: b\n\n",
    b"HTTP/1.1 200 OK\r\nX-Colon: a:b:c\r\nNoColon\r\n\r\n",
    b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n",
    b"HTTP/1.1 abc\r\n\r\n",
    b"garbage\r\n\r\n",
    b"",
]


@pytest.mark.parametrize("raw", _RAW_HEADS,
                         ids=[f"h{i}" for i in range(len(_RAW_HEADS))])
def test_client_read_head_matches_reference(raw):
    want = _read(jclient._read_head, raw, 5.0)
    got = _read(tclient._read_head, raw, 5.0)
    assert got == want


@pytest.mark.parametrize("reason", [None, FINISH_STOP, FINISH_LENGTH,
                                    FINISH_DEADLINE, FINISH_CANCELLED,
                                    "other"])
def test_failure_status_matches_reference(reason):
    got = tfront.HTTPFrontend._failure_status(reason)
    assert got == jfront.HTTPFrontend._failure_status(reason)
    assert got == {FINISH_DEADLINE: 504, FINISH_CANCELLED: 503}.get(reason)


_ARGVS = [
    [],
    ["--arch", "qwen3-1.7b", "--reduced", "--hashed"],
    ["--arch", "qwen3-1.7b", "--hashed", "--compression", "0.25"],
    ["--arch", "qwen3-1.7b", "--budget", "1/8", "--self-test"],
    ["--registry", "r", "--model-name", "a", "--model-name", "b@2",
     "--quota", "b=12"],
    ["--registry", "r", "--model-name", "a", "--quota", "a=3",
     "--quota", "b=0"],
    ["--registry", "r", "--model-name", "a", "--quota", "a:3"],
    ["--registry", "r", "--model-name", "a", "--quota", "a=-1"],
    ["--port", "0", "--host", "0.0.0.0", "--max-concurrency", "8",
     "--max-len", "512", "--page-size", "32", "--num-pages", "100"],
    ["--scheduler", "priority", "--queue-limit", "3", "--deadline", "0.5",
     "--prefix-cache", "--seed", "9"],
    ["--scheduler", "lottery"],
    ["--port", "eighty"],
]


def _flags(mod, argv):
    try:
        args = mod._parse_args(argv)
    except SystemExit as e:
        return ("exit", e.code)
    out = {k: v for k, v in vars(args).items() if k != "device"}
    try:
        quotas = mod._quotas(args)
    except SystemExit as e:
        quotas = ("exit", str(e))
    return ("ok", out, quotas, dataclasses.asdict(mod._sched_cfg(args)))


@pytest.mark.parametrize("argv", _ARGVS,
                         ids=[f"a{i}" for i in range(len(_ARGVS))])
def test_launcher_flags_match_reference(argv, capsys):
    want = _flags(jlaunch, argv)
    got = _flags(tlaunch, argv)
    assert got == want
    if got[0] == "ok":
        assert tlaunch._parse_args(argv).device == "cuda"


_TINY = dict(name="tiny-geom", family="dense", arch_kind="decoder",
             num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, remat=False,
             dtype="float32", tie_embeddings=True)

_GEOMETRIES = [
    (dict(), 1, 8),
    (dict(), 17, 8),
    (dict(num_layers=3), 9, 16),
    (dict(num_kv_heads=4), 5, 4),
    (dict(head_dim=32, d_model=128), 12, 8),
    (dict(dtype="bfloat16"), 7, 16),
    ("qwen3-1.7b", 33, 16),
]


@pytest.mark.parametrize("spec,num_pages,page_size", _GEOMETRIES,
                         ids=[f"g{i}" for i in range(len(_GEOMETRIES))])
def test_pool_geometry_matches_reference_eval_shape(spec, num_pages,
                                                    page_size, monkeypatch):
    if isinstance(spec, str):
        tcfg = TC.reduced(TC.get(spec))
        jcfg = JArchConfig(**dataclasses.asdict(tcfg))
    else:
        tcfg = ArchConfig(**{**_TINY, **spec})
        jcfg = JArchConfig(**{**_TINY, **spec})
    model = build(tcfg, device="cpu")

    def no_pool(*a, **k):
        raise AssertionError("the geometry check allocated a pool")
    monkeypatch.setattr(model, "init_paged_cache", no_pool)
    got = MultiModelEngine(page_size=page_size, device="cpu") \
        ._pool_geometry(model, num_pages)
    want = JMM(page_size=page_size)._pool_geometry(jbuild(jcfg), num_pages)
    for name in ("k", "v"):
        shape, dtype = want[name]
        assert got[0] == tuple(shape)
        assert got[1] == f"torch.{dtype}"
    assert jax.numpy.dtype(want["k"][1]) == jax.numpy.dtype(tcfg.dtype)
