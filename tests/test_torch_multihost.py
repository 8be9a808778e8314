"""The port's command channel (``engine/multihost.py``), mirroring
``tests/engine/test_multihost_channel.py``: a bad handshake never takes a
follower's place, a wrong token and a silent client are dropped, a
broadcast without followers times out, the token comes from the
environment, a chunked prefill replays token for token on a follower's
runner (chunk_start / chunk_continue / chunk_commit), an abort clears the
chunk register; and the port's own: the step key rides the wire as an
int, a follower whose socket closes makes the leader's engine fatal, and
``probe`` replays on the follower. Sockets on free ports; engines on the
CPU with ``tiny``."""

import json
import socket
import time

import numpy as np
import pytest
import torch

from gpustack_tpu_torch.engine import multihost as mh  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.engine.weights import load_or_init_params  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.models.config import get_config  # analysis: ignore[metrics-drift]
from gpustack_tpu_torch.parallel.mesh import free_port  # analysis: ignore[metrics-drift]


def _connect(port: int) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", port), 5.0)
    s.settimeout(5.0)
    return s


def _read_line(sock) -> dict:
    line = b""
    while not line.endswith(b"\n"):
        chunk = sock.recv(1 << 12)
        assert chunk, "channel closed before the op arrived"
        line += chunk
    return json.loads(line)


def test_bad_handshake_does_not_consume_follower_slot():
    port = free_port()
    leader = mh.CommandLeader(port, n_followers=1, token="sekrit")
    try:
        rogue = _connect(port)
        rogue.sendall(b"GET / HTTP/1.1\r\n\r\n")
        assert rogue.recv(64) == b""
        rogue.close()
        real = _connect(port)
        real.sendall(b"AUTH sekrit\n")
        assert leader._ready.wait(10), "follower never admitted"
        leader.broadcast({"op": "decode", "key": 12345678901})
        op = _read_line(real)
        assert op == {"op": "decode", "key": 12345678901}
        assert leader.error == ""
        real.close()
    finally:
        leader.close()


def test_wrong_token_rejected_silent_timeout_rejected():
    port = free_port()
    leader = mh.CommandLeader(port, n_followers=1, token="right")
    leader._HANDSHAKE_TIMEOUT_S = 1.0
    try:
        wrong = _connect(port)
        wrong.sendall(b"AUTH wrong\n")
        assert wrong.recv(64) == b""
        wrong.close()
        silent = _connect(port)
        t0 = time.time()
        assert silent.recv(64) == b""
        assert time.time() - t0 < 10
        silent.close()
        assert not leader._ready.is_set()
        ok = _connect(port)
        ok.sendall(b"AUTH right\n")
        assert leader._ready.wait(10)
        ok.close()
    finally:
        leader.close()


def test_broadcast_times_out_without_followers(monkeypatch):
    monkeypatch.setattr(mh, "_CONNECT_TIMEOUT_S", 0.5)
    leader = mh.CommandLeader(free_port(), n_followers=1, token="t")
    try:
        with pytest.raises(RuntimeError, match="follower"):
            leader.broadcast({"op": "decode", "key": 0})
    finally:
        leader.close()


def test_channel_token_from_env(monkeypatch):
    monkeypatch.setenv("GPUSTACK_TPU_CMD_TOKEN", "abc123")
    assert mh.channel_token() == "abc123"
    monkeypatch.delenv("GPUSTACK_TPU_CMD_TOKEN")
    assert mh.channel_token() == ""


def test_follower_gone_is_a_leader_error():
    """A follower's closed socket is seen at once, and the next broadcast
    raises it."""
    port = free_port()
    leader = mh.CommandLeader(port, n_followers=1, token="t")
    try:
        f = _connect(port)
        f.sendall(b"AUTH t\n")
        assert leader._ready.wait(10)
        f.close()
        deadline = time.time() + 10
        while not leader.error and time.time() < deadline:
            time.sleep(0.05)
        assert "disconnected" in leader.error
        with pytest.raises(RuntimeError, match="disconnected"):
            leader.broadcast({"op": "decode", "key": 1})
    finally:
        leader.close()


def _engine(**kw):
    cfg = get_config("tiny")
    params = load_or_init_params(cfg, None, seed=0, device="cpu")
    return LLMEngine(cfg, params, max_slots=2, max_seq_len=128,
                     device="cpu", **kw)


class RecordingRunner:
    """Wraps the follower's runner to record what it samples."""

    def __init__(self, runner):
        self._r = runner
        self.first_tokens = []
        self.decode_tokens = []

    def __getattr__(self, name):
        return getattr(self._r, name)

    def sample_first(self, *a, **kw):
        out = self._r.sample_first(*a, **kw)
        self.first_tokens.append(int(out[0][0]))
        return out

    def decode_step(self, state, key):
        assert isinstance(key, int)
        state, out = self._r.decode_step(state, key)
        self.decode_tokens.append(out[0].clone())
        return state, out


def test_chunked_prefill_replays_token_identical():
    """A leader engine (BroadcastingRunner over a live socket) serves a
    long prompt in chunks; a follower replays the stream on its own
    runner and samples the same tokens."""
    leader_eng = _engine(prefill_chunk=8)
    follower_eng = _engine(prefill_chunk=8)
    port = free_port()
    cl = mh.CommandLeader(port, n_followers=1, token="chunky")
    leader_eng.runner = mh.BroadcastingRunner(leader_eng.runner, cl)
    recorder = RecordingRunner(follower_eng.runner)
    kinds = []
    loop = mh.FollowerLoop(recorder, f"127.0.0.1:{port}",
                           state=follower_eng._state, token="chunky")
    orig_apply = loop._apply

    def spy_apply(op):
        kinds.append(op["op"])
        orig_apply(op)

    loop._apply = spy_apply
    loop.start()
    leader_eng.start()
    try:
        # chunks of the smallest bucket, 32: 100 tokens -> 32/32/32/4
        prompt = [(i * 7) % 250 + 3 for i in range(100)]
        req = leader_eng.generate(GenRequest(
            prompt_ids=prompt, max_tokens=5, temperature=0.0, stop_ids=(),
        ), timeout=600)
        assert len(req.output_ids) >= 1
        deadline = time.time() + 30
        while time.time() < deadline and (
            len(recorder.decode_tokens) < len(req.output_ids) - 1
            or "deactivate" not in kinds
        ):
            time.sleep(0.1)
        assert kinds.count("chunk_start") == 1
        assert kinds.count("chunk_continue") == 3
        assert kinds.count("chunk_commit") == 1
        assert recorder.first_tokens == [req.output_ids[0]]
        replayed = [int(t[0]) for t in recorder.decode_tokens]
        assert replayed[: len(req.output_ids) - 1] == req.output_ids[1:]
        # both sides' slot state: a probe replays on the follower
        mine = leader_eng.runner.probe(leader_eng._state, "slot_state")
        deadline = time.time() + 10
        while kinds[-1] != "probe" and time.time() < deadline:
            time.sleep(0.05)
        theirs = [torch.stack([loop.state.last_tokens,
                               loop.state.positions])]
        assert torch.equal(mine[0], theirs[0])
    finally:
        leader_eng.stop()
        loop.stop()
        cl.close()


def test_follower_loss_makes_the_engine_fatal():
    eng = _engine()
    port = free_port()
    cl = mh.CommandLeader(port, n_followers=1, token="t")
    eng.runner = mh.BroadcastingRunner(eng.runner, cl)
    f = _connect(port)
    f.sendall(b"AUTH t\n")
    assert cl._ready.wait(10)
    eng.start()
    try:
        assert eng.health()["status"] == "ok"
        f.close()
        deadline = time.time() + 10
        while eng.health()["status"] == "ok" and time.time() < deadline:
            time.sleep(0.05)
        health = eng.health()
        assert health["status"] == "error"
        assert "disconnected" in health["error"]
        with pytest.raises(ValueError, match="engine is down"):
            eng.submit(GenRequest(prompt_ids=[1, 2], max_tokens=2))
    finally:
        eng.stop()
        cl.close()


def test_chunk_abort_clears_follower_register():
    class DummyRunner:
        def prefill(self, ids, n, slot=None):
            return ("last", "k", "v")

    loop = mh.FollowerLoop(DummyRunner(), "127.0.0.1:1", state=None,
                           token="t")
    loop._apply({"op": "chunk_start", "ids": [1, 2], "true_len": 2})
    assert loop._chunk_regs.get(None) is not None
    loop._apply({"op": "chunk_abort"})
    assert None not in loop._chunk_regs
    loop._apply({"op": "prefill", "ids": [3], "true_len": 1})
    assert loop._reg == ("last", "k", "v")


def test_broadcasting_runner_refuses_single_process_features():
    eng = _engine()
    runner = mh.BroadcastingRunner(eng.runner, leader=None)
    assert runner.supports_async_insert is False
    # the host tier's prefix prefill, the verify step, an embedding
    # batch and an image prefill are served over the channel
    # (tests/test_torch_multigpu_*.py); a draft's ingestion is rank 0's
    with pytest.raises(ValueError, match="multi-GPU replica"):
        runner.ingest_step()

    class Channel:
        ops = []

        def broadcast(self, op):
            self.ops.append(op)

    runner = mh.BroadcastingRunner(eng.runner, Channel())
    rows = [[5, 6, 7] + [0] * 29, [8] + [0] * 31]
    got = runner.embed(rows, [3, 1])
    assert Channel.ops == [{"op": "embed", "ids": rows, "lens": [3, 1]}]
    assert torch.equal(got, eng.runner.embed(rows, [3, 1]))
    # an image prefill names its rows as runs of the mask, never the rows
    ids = [5, 6, 7, 8, 9] + [0] * 27
    mask = np.zeros(32, bool)
    mask[1:3] = mask[4] = True
    embeds = np.zeros((32, eng.cfg.hidden_size), np.float32)
    embeds[mask] = np.random.default_rng(0).normal(size=(3, 64))
    Channel.ops.clear()
    got = runner.prefill_with_embeds(ids, 5, embeds, mask, slot=1)
    assert Channel.ops == [{"op": "prefill_with_embeds", "ids": ids,
                            "true_len": 5, "slot": 1,
                            "rows": [[1, 2], [4, 1]]}]
    want = eng.runner.prefill_with_embeds(ids, 5, embeds, mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (mh.mask_of(Channel.ops[0]["rows"], 32) == mask).all()
