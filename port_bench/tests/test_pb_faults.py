"""The check fails what it should: the control (the reference at the next
lower precision in the program's place) and a run whose timed path is
broken underneath.  These drive the whole run on the CPU at tiny widths
(the look for a card skipped), with the configuration's limits."""

import pytest
import torch

from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.models import vocoder_stream

from port_bench import run

from conftest import TINY_MIXES

CELLS = {"serve_closed": "int8-backlog", "serve_open": "int8-voice-open",
         "stream_closed": "int8-solo-stream"}


def run_tiny(config, kind, control=False, seed=2**31 + 7):
    cell = {"name": CELLS[kind], "chips": 1}
    return run.run_cell(run.manifest(), cell, seed, 2.0, False, device="cpu", control=control,
                        config=config, traffic_spec=TINY_MIXES[kind])


@pytest.mark.parametrize("kind", sorted(TINY_MIXES))
def test_sound_run_is_correct_and_the_control_is_not(tiny_config, kind):
    res = run_tiny(tiny_config, kind, control=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["judged_greedy"]["value"] >= 1
    assert res["checks"]["judged_sampled"]["value"] >= 1
    assert set(res["control"]) == {tiny_config["control"]["lm"]}
    assert not any(c["correct"] for c in res["control"].values()), res["control"]


def altered_codes(monkeypatch):
    """A residual code altered where the decode produces it."""
    inner = decode.decode_chunk

    def chunk(*args, **kw):
        state, frames, emitted = inner(*args, **kw)
        frames = frames.clone()
        frames[..., 3] = (frames[..., 3] + 1) % 24
        return state, frames, emitted

    monkeypatch.setattr(decode, "decode_chunk", chunk)


def unchanged_state(monkeypatch):
    """A decode step that returns its state unchanged."""
    inner = decode.decode_chunk

    def chunk(params, rope, state, *args, **kw):
        saved = {k: (v.clone() if torch.is_tensor(v) else {kk: vv.clone() for kk, vv in v.items()})
                 for k, v in state.items()}
        out = inner(params, rope, state, *args, **kw)
        for k, v in saved.items():
            if torch.is_tensor(v):
                state[k].copy_(v)
            else:
                for kk, vv in v.items():
                    state[k][kk].copy_(vv)
        return out

    monkeypatch.setattr(decode, "decode_chunk", chunk)


def altered_pcm(monkeypatch):
    """The pool codec's PCM altered where it is made."""
    inner = vocoder_stream.decode_chunk_pool

    def pool(*args, **kw):
        state, audio = inner(*args, **kw)
        return state, audio + 0.5

    monkeypatch.setattr(vocoder_stream, "decode_chunk_pool", pool)


def altered_stream_pcm(monkeypatch):
    inner = vocoder_stream.decode_chunk

    def one(*args, **kw):
        state, audio = inner(*args, **kw)
        return state, audio + 0.5

    monkeypatch.setattr(vocoder_stream, "decode_chunk", one)


def sampling_fault(column: int, value: float):
    """One sampling parameter of the requests that sample replaced where the
    decode reads it (0 temperature, 1 top-p, 2 repetition penalty)."""
    def fault(monkeypatch):
        inner = decode.set_sampling

        def set_sampling(state, *params):
            inner(state, *params)
            col = state["sampling"]
            sampled = col[0] > 0.01  # the greedy requests decode at 1e-5
            col[column] = torch.where(sampled, torch.full_like(col[column], value), col[column])

        monkeypatch.setattr(decode, "set_sampling", set_sampling)
    fault.__name__ = f"sampling_{column}_{value}"
    return fault


hot_temperature, whole_vocabulary = sampling_fault(0, 1.0), sampling_fault(1, 1.0)


@pytest.mark.parametrize("kind,fault", [
    ("serve_closed", hot_temperature), ("serve_closed", whole_vocabulary),
    ("serve_open", hot_temperature), ("stream_closed", hot_temperature),
    ("serve_closed", altered_codes), ("serve_closed", unchanged_state),
    ("serve_closed", altered_pcm), ("serve_open", altered_codes),
    ("stream_closed", altered_codes), ("stream_closed", unchanged_state),
    ("stream_closed", altered_stream_pcm)])
def test_a_broken_timed_path_is_not_correct(tiny_config, monkeypatch, kind, fault):
    fault(monkeypatch)
    res = run_tiny(tiny_config, kind)
    assert not res["correct"], res["checks"]


def test_rate_and_records_for_the_knee_sweep(tiny_config, tmp_path):
    """``--rate`` replaces an open mix's arrival rate; ``--dump`` writes every
    request's record, its due time from the window's opening."""
    import json

    path = tmp_path / "records.jsonl"
    res = run.run_cell(run.manifest(), {"name": "int8-voice-open", "chips": 1}, 3, 2.0, False,
                       device="cpu", rate=2.0, config=tiny_config,
                       traffic_spec=TINY_MIXES["serve_open"], dump=str(path))
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    due = sorted(r["due"] for r in recs)
    assert len(recs) >= res["attempted"] >= 1 and due[0] > 0
    assert all(r["deliveries"] for r in recs if r["due"] < 2.0)
    assert 2 <= sum(1 for d in due if d < 2.0) <= 8  # about 2/s over 2 s
