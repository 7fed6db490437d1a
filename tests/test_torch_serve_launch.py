"""The port's serve launcher: ``--ckpt-dir``, ``--stop``, ``--stream``,
``--slots`` and the graceful drain.

- A checkpoint written by ``repro_torch.launch.train.run`` serves
  through ``launch.serve --ckpt-dir`` the greedy tokens of an in-process
  ``Engine`` on the trained state's params; so does a ``{"params",
  "opt", "step"}`` checkpoint written by the JAX package's
  ``repro.train.checkpoint.save``, against its params carried across.
- ``--stop`` ends a request with reason ``stop``; ``--stream`` prints
  ``RequestOutput`` deltas; ``--slots`` with ``--max-concurrency`` is an
  error.
- The drain in process: the handler's first call asks for it, the serve
  loop then cancels the queued requests (terminal "cancelled" deltas) and
  lets the in-flight rows finish; its second call exits with 130.  A
  real SIGINT goes only to a child launcher, which drains, prints the
  metrics table and exits 0.  No test here signals the pytest process.
"""
import json
import os
import re
import select
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.models import build as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt

import repro_torch.configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--hashed", "--device", "cpu"]
_REQ = re.compile(r"^req (\d+): (\[[^\]]*\])  \(finish=(\w+)")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfg():
    return TC.reduced(TC.get("qwen3-1.7b")).hashed_variant(0.125)


def _served(out: str):
    """{uid: (tokens, finish reason)} from the launcher's output."""
    got = {}
    for line in out.splitlines():
        m = _REQ.match(line)
        if m:
            got[int(m.group(1))] = (json.loads(m.group(2)), m.group(3))
    return got


def _in_process(params, n=3, max_new=5):
    """The launcher's requests through an in-process engine built as the
    launcher builds it."""
    cfg = _cfg().with_(hash_path="pallas")
    eng = Engine(tbuild(cfg, device="cpu"), params, device="cpu",
                 max_concurrency=4, max_len=256, eos_id=-1)
    for uid, p in enumerate(serve.prompts(n, cfg.vocab_size)):
        assert eng.submit(Request(uid=uid, prompt=p,
                                  sampling=SamplingParams(max_tokens=max_new)))
    eng.run()
    return {r.uid: r.tokens for r in eng._done}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ck"))
    out = tlaunch.run(_cfg(), steps=2, batch=2, seq=16, ckpt_dir=d,
                      device="cpu", log_every=0, lr=3e-2)
    return d, out["state"]["params"]


def test_ckpt_from_the_port_trainer_serves_its_params(trained, capsys):
    d, params = trained
    assert serve.main(ARGS + ["--requests", "3", "--max-new", "5",
                              "--ckpt-dir", d]) == 0
    out = capsys.readouterr().out
    assert f"loaded params from {d}" in out
    got = _served(out)
    assert {u: t for u, (t, _) in got.items()} == _in_process(params)
    # the served params are the trained ones, not the seeded init's
    init = tbuild(_cfg(), device="cpu").init(0)
    assert not torch.equal(init["layers"]["ffn"]["out"]["w"],
                           params["layers"]["ffn"]["out"]["w"])


def test_ckpt_from_the_reference_trainer_serves_its_params(tmp_path,
                                                           capsys):
    jc = jreduced(JC.get("qwen3-1.7b")).hashed_variant(0.125)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(1))
    jo = jopt.adamw(jopt.constant_lr(1e-3))
    d = str(tmp_path / "j")
    jckpt.save({"params": jp, "opt": jo.init(jp),
                "step": jnp.asarray(3, jnp.int32)}, d, 3)
    assert serve.main(ARGS + ["--requests", "3", "--max-new", "5",
                              "--ckpt-dir", d]) == 0
    got = _served(capsys.readouterr().out)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), _cfg(),
                               device="cpu")
    assert {u: t for u, (t, _) in got.items()} == _in_process(params)


def test_stop_ends_with_reason_stop_and_stream_prints_deltas(trained,
                                                             capsys):
    d, params = trained
    want = _in_process(params)
    stop = ",".join(str(t) for t in want[0][:2])
    assert serve.main(ARGS + ["--requests", "3", "--max-new", "5",
                              "--ckpt-dir", d, "--stream", "--stop", stop,
                              "--stop", "1,2,3"]) == 0
    out = capsys.readouterr().out
    got = _served(out)
    assert got[0] == (want[0][:2], "stop")
    for uid in (1, 2):
        if want[uid][:2] != want[0][:2]:
            assert got[uid] == (want[uid], "length")
    deltas = [line for line in out.splitlines()
              if re.match(r"^req \d+ \+= \[", line)]
    streamed = {}
    for line in deltas:
        uid, toks = re.match(r"^req (\d+) \+= (\[[^\]]*\])", line).groups()
        streamed.setdefault(int(uid), []).extend(json.loads(toks))
    assert streamed == {u: t for u, (t, _) in got.items()}
    assert sum("[stop]" in line for line in deltas) >= 1
    assert "finish reasons: {'stop':" in out


def test_slots_with_max_concurrency_is_an_error(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(ARGS + ["--slots", "2", "--max-concurrency", "2"])
    assert e.value.code == 2
    assert "deprecated alias" in capsys.readouterr().err


def test_drain_cancels_queued_and_finishes_in_flight(capsys):
    cfg = _cfg()
    model = tbuild(cfg, device="cpu")
    eng = Engine(model, model.init(0), device="cpu", max_concurrency=2,
                 max_len=64, eos_id=-1)
    handles = [eng.submit(Request(uid=u, prompt=p, max_new_tokens=4))
               for u, p in enumerate(serve.prompts(6, cfg.vocab_size))]
    eng.step()                               # row 0 admitted
    drain = serve.Drain()
    drain(signal.SIGTERM, None)
    assert drain.requested
    serve.serve_loop(eng, handles, drain, stream=True)
    out = capsys.readouterr().out
    assert "draining" in out and "cancelled 5 queued request(s)" in out
    assert [r.uid for r in eng._done] == [0]
    assert len(eng._done[0].tokens) == 4
    assert all(h.req.finish_reason == "cancelled" for h in handles[1:])
    assert sum("[cancelled]" in line for line in out.splitlines()) == 5
    with pytest.raises(SystemExit) as e:
        drain(signal.SIGTERM, None)
    assert e.value.code == 130


def test_sigint_to_a_child_launcher_drains_and_exits_cleanly(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    child = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve"] + ARGS
        + ["--requests", "64", "--max-concurrency", "1", "--max-new", "32",
           "--stream"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        seen = []
        while not any(line.startswith("req 0 +=") for line in seen):
            ready, _, _ = select.select([child.stdout], [], [], 120)
            assert ready, f"no delta in 120 s: {seen}"
            line = child.stdout.readline()
            assert line, f"child ended early: {child.stderr.read()}"
            seen.append(line)
        child.send_signal(signal.SIGINT)
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err[-3000:]
    assert "draining" in out and "queued request(s)" in out
    assert "--- metrics ---" in out
    got = _served(out)
    assert got and all(r in ("length", "stop") for _, r in got.values())
    assert len(got) < 64
