"""The cells of this file's list on the CPU: `serve.tcp_closed` (the TCP
server on its CLI path, clients in a process of their own, replies decoded
strictly) and `batch.long_shared` (four queries on one Seq1 a call) come out
correct at a small size and report their metrics; a server broken in each
way the serve cell can be broken comes out not correct; the reply decoder
refuses every reply out of form."""

import time

import pytest
import torch

from psabench import registry, replies, run, serve_spans

CELLS = ("serve.tcp_closed", "batch.long_shared")
SERVE_METRICS = {"serve_read_ms", "serve_parse_ms", "serve_queue_ms",
                 "serve_reply_ms", "serve_chunk_queries"}
# three clients on a pool of three queries: client c's k-th line is pool
# query (c + k) % 3, so a chunk mixes clients and their queries
SERVE_MIX = {"seq1_len": 2000, "seq2_len": 500, "clients": 3, "pool": 3,
             "reply_timeout_s": 5}


def small(cell, small_mix):
    return SERVE_MIX if cell == "serve.tcp_closed" else small_mix


def run_small(cell, mix, seconds=1.5, traced=False, seed=123456789012):
    return run.run_cell(registry.cell(cell), seed, seconds, traced,
                        torch.device("cpu"), time.perf_counter(), mix,
                        log=lambda line: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small_mix):
    res = run_small(cell, small(cell, small_mix))
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["checks"]["checked"]["value"] == res["attempted"] * (
        1 if cell == "serve.tcp_closed" else 4)
    assert set(res["metrics"]) == {"pair_evals_per_s", "request_ms_p95",
                                   "setup_s"}


@pytest.mark.parametrize("cell,want", [
    ("serve.tcp_closed", SERVE_METRICS),
    ("batch.long_shared", {"shared_launch_pct"})])
def test_a_traced_run_reports_the_cells_metrics(cell, want, small_mix):
    # the serve spans are read outside the profile, which records 2 s from
    # 30 % into the window
    res = run_small(cell, small(cell, small_mix), traced=True,
                    seconds=6.0 if cell == "serve.tcp_closed" else 2.5)
    assert res["correct"] is True
    assert set(res["metrics"]) == want
    assert "busy_s" in res["device"] and "breakdown" in res
    if cell == "serve.tcp_closed":
        m = {k: v["value"] for k, v in res["metrics"].items()}
        assert 1 <= m["serve_chunk_queries"] <= SERVE_MIX["clients"]
        assert all(m[k] >= 0 for k in SERVE_METRICS)
    else:
        assert res["metrics"]["shared_launch_pct"]["value"] == 100.0


def test_the_shared_cell_runs_the_shared_seq1_dispatch(small_mix,
                                                       monkeypatch):
    from psa_torch.models import batch

    seen, orig = [], batch.batched_search_exact

    def spy(*a, **k):
        seen.append(k.get("shared_s1"))
        return orig(*a, **k)
    monkeypatch.setattr(batch, "batched_search_exact", spy)
    res = run_small("batch.long_shared", small_mix, seconds=0.3)
    assert res["correct"] is True
    assert seen and all(s is True for s in seen)


def wrong_substitute(monkeypatch):
    """The mutant carries the next letter of the alphabet in place of the
    winner's substitute."""
    from psa_torch.core.result import SearchResult

    def mutant(self, seq2):
        i = self.char_offset
        other = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[(self.sub_code + 1) % 26]
        return seq2[:i] + other + seq2[i + 1:]
    monkeypatch.setattr(SearchResult, "mutant", mutant)


def crossed_connections(monkeypatch):
    """The first two replies of a chunk from two connections swap
    connections."""
    from psa_torch.utils import server

    orig = server.TCPQueryServer._route

    def crossed(self, sel, fifo, batch, chunk, payload):
        outputs, nq, dt = payload
        if len(batch) >= 2 and batch[0][0] is not batch[1][0]:
            outputs = [outputs[1], outputs[0], *outputs[2:]]
        return orig(self, sel, fifo, batch, chunk, (outputs, nq, dt))
    monkeypatch.setattr(server.TCPQueryServer, "_route", crossed)


def a_reply_never_comes(monkeypatch):
    """The first reply the server routes is dropped."""
    from psa_torch.utils import server

    orig, dropped = server.TCPQueryServer._route, []

    def drop_one(self, sel, fifo, batch, chunk, payload):
        outputs, nq, dt = payload
        if not dropped:
            dropped.append(outputs[0])
            outputs = [None, *outputs[1:]]
        return orig(self, sel, fifo, batch, chunk, (outputs, nq, dt))
    monkeypatch.setattr(server.TCPQueryServer, "_route", drop_one)


FAULTS = [wrong_substitute, crossed_connections, a_reply_never_comes]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_a_broken_server_comes_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    t0 = time.perf_counter()
    res = run_small("serve.tcp_closed", SERVE_MIX)
    assert res["correct"] is False
    n = res["checks"]
    assert n["wrong_answers"]["value"] > 0 or n["failed_requests"]["value"] > 0
    if fault is a_reply_never_comes:
        # a failed request, counted once the client's wait ran out
        assert res["failed"] >= 1 and n["failed_requests"]["value"] >= 1
        assert time.perf_counter() - t0 < 60


SEQ2 = "ABCDEFGH"


@pytest.mark.parametrize("reply,want", [
    ("3 -12 ABCDXFGH", (3, 4, 23, -12.0)),
    ("0 1e+06 -BCDEFGH", (0, 0, 26, 1e6)),
    ("12 999999 ABCDEFGZ", (12, 7, 25, 999999.0)),
    ("-1 inf ABCDEFGH", None),
    ("-1 -inf ABCDEFGH\n", None),
])
def test_a_reply_decodes_to_the_winner(reply, want):
    assert replies.decode(reply, SEQ2) == want


@pytest.mark.parametrize("reply", [
    "error bad query line",
    "3 -12 ABCDEFGH",             # no position changed
    "3 -12 XBCDEFGX",             # two positions changed
    "3 -12 ABCDXFG",              # another length
    "3 -12 ABCD?FGH",             # a substitute outside the alphabet
    "3 -12.0 ABCDXFGH",           # a score %g would not print
    "3 1000000 ABCDXFGH",         # ... nor this one
    "+3 -12 ABCDXFGH",
    "03 -12 ABCDXFGH",
    "-1 inf ABCDEFGX",            # "no mutation" with another Seq2
    "-1 -12 ABCDXFGH",
    "3 nan ABCDXFGH",
    "3  -12 ABCDXFGH",
    "",
])
def test_a_reply_out_of_form_never_equals_an_answer(reply):
    got = replies.decode(reply, SEQ2)
    assert got == replies.malformed(reply)
    assert got is not None and len(got) != 4


@pytest.mark.parametrize("metric", sorted(SERVE_METRICS))
def test_without_serve_spans_the_serve_metrics_read_nothing(metric,
                                                            monkeypatch):
    """The parent of these spans: no `serve_chunk`, no value, no raise."""
    from psabench import program_spans
    from psabench.traffic.closed_loop import Request

    ctx = run.Context({}, {}, {}, 0.0, [Request(0, 1.0, 2.0, [None])], 1.0,
                      1, 1, 1.0)
    monkeypatch.setattr(program_spans, "records", lambda: [])
    assert serve_spans.window(ctx) is None
    mod = next(m for m in registry.metrics()
               if registry.metric_name(m) == metric)
    assert mod.read(ctx) is None
