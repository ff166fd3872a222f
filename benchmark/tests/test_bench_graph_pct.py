"""The reader of ``greedy_graph_pct.decode`` (the port's
``greedy.graph_replays`` counter over its ``greedy.steps``) on the fake
decode window of ``test_bench_port_spans.py``; None without a trace, in a
window the port recorded nothing in, on a port without the recorder, and on
a port that counts steps but no replays."""

from benchmark.tests.test_bench_port_spans import MS, SPEC, T0, decode_ctx
# the empty recorder of each test, autouse here too
from benchmark.tests.test_bench_port_spans import recorder  # noqa: F401
from ts_asr_whisper_tpu_torch.utils import observability as obs

NAME = "greedy_graph_pct.decode"


def replays(*at_ms):
    for t in at_ms:
        obs._counts.append(("greedy.graph_replays", T0 + t * MS, 1))


def test_entry_lists_the_decode_cell():
    entry = next(m for m in SPEC.data["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["dicow_v3.greedy_longform"]
    assert (entry["unit"], entry["better"], entry["layer"],
            entry["moves"]) == ("%", "higher", "decode loops", "decode_rtfx")


def test_reads_replays_over_steps():
    ctx = decode_ctx()          # two greedy steps
    replays(50)
    assert SPEC.reader(NAME)(ctx) == 50.0
    replays(80)
    assert SPEC.reader(NAME)(ctx) == 100.0


def test_finds_nothing(monkeypatch):
    read = SPEC.reader(NAME)
    ctx = decode_ctx()
    assert read(ctx) is None    # steps counted, no replay: the parent
    replays(50, 80)
    assert read(dict(ctx, trace=None)) is None
    empty = dict(ctx["trace"], start_ns=T0 - 10 ** 12,
                 end_ns=T0 - 10 ** 12 + 200 * MS)
    assert read(dict(ctx, trace=empty)) is None
    monkeypatch.delattr(obs, "spans_between")
    assert read(ctx) is None
