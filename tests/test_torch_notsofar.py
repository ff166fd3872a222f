"""The port's copies of the NOTSOFAR-1 meeting-directory loader
(data/notsofar.py) and the warn-on-call decorator (utils/deprecated.py)
against the JAX package's, after tests/test_notsofar.py and
tests/test_misc_utils.py: the same meeting directories give the same
session, utterance and meeting frames, the same cuts and the same
concatenated close-talk audio from both packages. The loader needs pandas,
which the card's image lacks; these tests skip without it."""

import json
import warnings

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from test_notsofar import _make_meeting  # noqa: E402
from ts_asr_whisper_tpu.data import notsofar as jnsf  # noqa: E402
from ts_asr_whisper_tpu_torch.data import notsofar as tnsf  # noqa: E402
from ts_asr_whisper_tpu_torch.data.audio import (load_audio,  # noqa: E402
                                                 save_wav)


def _assert_frames_equal(got, want):
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)


def test_load_data_and_cutset(tmp_path):
    for name in ("MTG_001", "MTG_002"):
        _make_meeting(tmp_path, name)
    sessions, gt, meta = tnsf.load_data(str(tmp_path))
    assert len(sessions) == 2  # close-talk dropped
    assert sessions.session_id.str.startswith("singlechannel/").all()
    assert len(gt) == 4 and len(meta) == 2
    _assert_frames_equal((sessions, gt, meta), jnsf.load_data(str(tmp_path)))

    cs = tnsf.sessions_to_cutset(sessions, gt)
    ref = jnsf.sessions_to_cutset(*jnsf.load_data(str(tmp_path))[:2])
    assert len(cs) == len(ref) == 2
    assert {s.speaker for s in cs[0].supervisions} == {"alice", "bob"}
    for c, r in zip(cs, ref):
        assert c.id == r.id and c.duration == r.duration
        assert [(s.speaker, s.start, s.duration, s.text)
                for s in c.supervisions] == \
            [(s.speaker, s.start, s.duration, s.text)
             for s in r.supervisions]

    ct, _, _ = tnsf.load_data(str(tmp_path), return_close_talk=True)
    assert (ct.device_name == "close_talk").all()
    _assert_frames_equal(
        (ct,), jnsf.load_data(str(tmp_path), return_close_talk=True)[:1])

    query = "meeting_id == 'MTG_001'"
    some, _, _ = tnsf.load_data(str(tmp_path), session_query=query)
    assert len(some) == 1
    _assert_frames_equal(
        (some,), jnsf.load_data(str(tmp_path), session_query=query)[:1])


def test_close_talk_concat(tmp_path):
    """GT spans concatenated into a new wav, the GT timings shifted onto
    the concatenated timeline; the port's wav and frames equal the JAX
    package's."""
    d = tmp_path / "meetings" / "MTG_CT"
    d.mkdir(parents=True)
    sr = 16000
    rng = np.random.default_rng(1)
    save_wav(str(d / "ct_head.wav"),
             rng.standard_normal(2 * sr).astype(np.float32) * 0.1, sr)
    (d / "devices.json").write_text(json.dumps([
        {"device_name": "head0", "is_close_talk": True, "is_mc": False,
         "wav_file_names": "ct_head.wav"}]))
    (d / "gt_transcription.json").write_text(json.dumps([
        {"start_time": 0.25, "end_time": 0.75, "text": "hello",
         "speaker_id": "alice", "ct_wav_file_name": "ct_head.wav",
         "word_timing": [["hello", 0.25, 0.75]]},
        {"start_time": 1.0, "end_time": 1.5, "text": "world",
         "speaker_id": "alice", "ct_wav_file_name": "ct_head.wav",
         "word_timing": [["world", 1.0, 1.5]]}]))

    runs = {}
    for tag, mod in (("port", tnsf), ("jax", jnsf)):
        sessions, gt, _ = mod.load_data(
            str(tmp_path / "meetings"), return_close_talk=True,
            out_dir=str(tmp_path / tag))
        wavs = sessions.iloc[0]["wav_file_names"]
        assert len(wavs) == 1 and "concat_close_talk" in wavs[0]
        runs[tag] = (sessions, gt, load_audio(wavs[0]))
    sessions, gt, (samples, sr2) = runs["port"]
    assert sr2 == sr and samples.shape[-1] == sr  # two 0.5 s spans
    np.testing.assert_allclose(gt["start_time"], [0.0, 0.5], atol=1e-9)
    np.testing.assert_allclose(gt["end_time"], [0.5, 1.0], atol=1e-9)
    assert gt.iloc[1]["word_timing"] == [["world", 0.5, 1.0]]
    j_sessions, j_gt, (j_samples, _) = runs["jax"]
    np.testing.assert_array_equal(samples, j_samples)
    pd.testing.assert_frame_equal(gt, j_gt)
    assert sessions.drop(columns="wav_file_names").equals(
        j_sessions.drop(columns="wav_file_names"))


def test_deprecated_decorator():
    from ts_asr_whisper_tpu_torch.utils.deprecated import deprecated

    @deprecated("use new_fn")
    def old_fn(x):
        return 42 + x

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert old_fn(1) == 43
    assert [x.category for x in w] == [DeprecationWarning]
    assert str(w[0].message) == \
        "test_deprecated_decorator.<locals>.old_fn is deprecated. use new_fn"
    assert old_fn.__name__ == "old_fn"
