"""The port's HTTP serving launcher (``repro_torch.launch.serve_http``).

- ``--self-test --device cpu`` in a child process: the JSON and the
  streamed completion through the server equal a direct ``Engine``'s
  tokens, and the child exits 0.
- ``_serve`` in a child process on port 0, hosting two registry models
  (one with a ``--quota``) on one shared pool: each tenant's greedy
  completion equals a dedicated in-process engine's on the same
  artifact; SIGTERM then drains it, and it prints the metrics table and
  exits 0.  Signals go only to child processes, never to pytest's.
- Flag errors: ``--model-name`` without ``--registry``, a bad
  ``--quota``, and neither ``--arch`` nor a registry model.
"""
import asyncio
import json
import os
import re
import select
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch import artifact
from repro_torch.artifact import registry
from repro_torch.launch import serve_http
from repro_torch.models import build
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.http import client as http_client

ROOT = Path(__file__).resolve().parents[1]
_SERVING = re.compile(r"^serving on http://([\d.]+):(\d+)")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_self_test_on_cpu_passes_in_a_child(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_http", "--arch",
         "qwen3-1.7b", "--reduced", "--hashed", "--device", "cpu",
         "--self-test"], env=_env(), cwd=tmp_path, capture_output=True,
        text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["self_test"] == "pass"
    assert res["json_tokens"] == res["expected"]["0"]
    assert res["stream_tokens"] == res["expected"]["1"]
    assert len(res["json_tokens"]) == 8


def test_registry_roster_in_a_child_serves_then_drains_on_sigterm(tmp_path):
    cfg = TC.reduced(TC.get("qwen3-1.7b"))
    root = str(tmp_path / "reg")
    prompts = {"dense": [5, 9, 13, 2, 77], "hashed": [8, 3, 41, 6, 6, 19]}
    want = {}
    for tag, c in (("dense", cfg), ("hashed", cfg.hashed_variant(0.125))):
        m = build(c, device="cpu")
        params = m.init(3)
        path = str(tmp_path / f"{tag}.hnart")
        artifact.export_model(path, c, params)
        registry.register(root, tag, path)
        # a dedicated engine with the launcher's knobs
        eng = Engine(m, params, device="cpu", slots=4, max_len=64, eos_id=-1,
                     page_size=16)
        eng.submit(Request(uid=0, prompt=np.array(prompts[tag], np.int32),
                           max_new_tokens=6))
        want[tag] = eng.run()[0].tokens

    child = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve_http",
         "--registry", root, "--model-name", "dense", "--model-name",
         "hashed@1", "--quota", "hashed=12", "--device", "cpu",
         "--port", "0", "--max-len", "64"],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        host = port = None
        while port is None:
            ready, _, _ = select.select([child.stdout], [], [], 120)
            assert ready, "the launcher printed no address in 120 s"
            line = child.stdout.readline()
            assert line, f"child ended early: {child.stderr.read()[-3000:]}"
            m = _SERVING.match(line)
            if m:
                host, port = m.group(1), int(m.group(2))
                assert "['dense', 'hashed']" in line

        async def ask():
            got = {}
            for tag, pr in prompts.items():
                status, body = await http_client.request(
                    host, port, "POST", "/v1/completions",
                    dict(model=tag, prompt=pr, max_tokens=6), timeout=60)
                assert status == 200, body
                got[tag] = body["choices"][0]["token_ids"]
            return got
        got = asyncio.run(asyncio.wait_for(ask(), 120))
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert got == want
    assert child.returncode == 0, err[-3000:]
    assert "draining" in out and "--- metrics ---" in out
    assert "model.hashed.kv.pages_held" in out


def test_flag_errors(capsys):
    with pytest.raises(SystemExit, match="requires --registry"):
        serve_http.main(["--model-name", "a", "--device", "cpu"])
    with pytest.raises(SystemExit, match="bad --quota"):
        serve_http.main(["--registry", "r", "--model-name", "a",
                         "--quota", "a:3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--arch or --registry"):
        serve_http.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --arch"):
        serve_http.main(["--device", "cpu", "--self-test"])
