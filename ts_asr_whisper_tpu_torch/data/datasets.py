"""Datasets of the port over cut manifests: the (cut x speaker) training
dataset and the long-form eval datasets, with SE-DiCoW's enrollment
selection.

A copy of ts_asr_whisper_tpu/data/datasets.py:29-30, 39-40, 43-578
(``round_nearest``, ``get_cut_recording_id``, the
``TS_ASR_DatasetSuperclass`` methods with the enrollment selection,
``TS_ASR_Dataset``, ``LhotseLongFormDataset``, ``load_cutsets``,
``build_datasets``). That module imports the jax log-mel module at the top;
only the imports differ here, the featurizer is the port's numpy copy, and
``get_features`` is a ``data.features`` span and counts ``data.mel_calls``
(utils/observability.py).
"""

from __future__ import annotations

import re
from dataclasses import replace
from functools import reduce
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.logging_def import get_logger
from ..utils.observability import count, span
from .features import extract_features
from .manifests import Cut, CutSet, MixTrack, MixedCut, MonoCut, load_manifest
from .stno import create_stno_mask, downsample_speaker_mask

logger = get_logger(__name__)


def round_nearest(x: float, a: float) -> float:
    return round(x / a) * a


def get_cut_recording_id(cut: Cut) -> str:
    return cut.recording_id if isinstance(cut, MonoCut) else cut.id


class TS_ASR_DatasetSuperclass:
    """Shared logic for segment-level and long-form datasets
    (local_datasets.py:30-479)."""

    def __init__(
        self,
        cutsets: Sequence[CutSet],
        text_norm: Callable[[str], str] = lambda x: x,
        use_timestamps: bool = False,
        max_timestamp_pause: float = 0.0,
        model_features_subsample_factor: int = 2,
        dataset_weights: Optional[Sequence[int]] = None,
        num_mel_bins: int = 80,
        global_lang_id: Optional[str] = None,
        load_channel_zero_only: bool = False,
        musan_augment_prob: float = 0.0,
        musan_root: Optional[str] = None,
        use_enrollments: bool = False,
        enrollment_cutset: Optional[CutSet] = None,
        num_other_speakers: int = 0,
        min_overlap_ratio: float = 0.0,
        max_overlap_ratio: float = 1.0,
        **kwargs,
    ):
        self.cutsets = list(cutsets)
        self.dataset_weights = list(dataset_weights or [1] * len(self.cutsets))
        assert len(self.cutsets) == len(self.dataset_weights)

        self.use_enrollments = use_enrollments
        if use_enrollments:
            parents = [cs.parent_cutset for cs in self.cutsets
                       if cs.parent_cutset is not None]
            if parents:
                self.parent_csets = reduce(lambda a, b: a + b, parents)
                self.parent_recording_to_id = {
                    get_cut_recording_id(c): i
                    for i, c in enumerate(self.parent_csets)}
            else:
                self.parent_csets = None
            self.num_other_speakers = num_other_speakers
            self.min_overlap_ratio = min_overlap_ratio
            self.max_overlap_ratio = max_overlap_ratio
            self.per_speaker_enrollments: Dict[str, CutSet] = {}
            if enrollment_cutset:
                tmp: Dict[str, list] = {}
                for cut in enrollment_cutset:
                    for spk in cut.speakers:
                        tmp.setdefault(spk, []).append(cut)
                self.per_speaker_enrollments = {
                    k: CutSet(v) for k, v in tmp.items()}
                self.enrollment_speakers = list(self.per_speaker_enrollments)

        self.cset = reduce(lambda a, b: a + b, self.cutsets)
        self.max_timestamp_pause = max_timestamp_pause
        self.use_timestamps = use_timestamps
        self.text_norm = text_norm
        self.num_mel_bins = num_mel_bins
        self.model_features_subsample_factor = model_features_subsample_factor
        self.global_lang_id = global_lang_id
        self.load_channel_zero_only = load_channel_zero_only
        self.musan_augment_prob = musan_augment_prob
        self.musan_augment = None
        if musan_augment_prob > 0.0 and musan_root:
            from .augmentations import RandomBackgroundNoise

            self.musan_augment = RandomBackgroundNoise(16000, musan_root)
        self.prepare_cuts()

    # -- indexing ---------------------------------------------------------
    def prepare_cuts(self):
        mapping = []
        for cutset, weight in zip(self.cutsets, self.dataset_weights):
            spk_per_cut = np.array([len(c.speakers) for c in cutset]) * weight
            mapping.append(spk_per_cut)
        self.to_index_mapping = np.cumsum(np.concatenate(mapping)) \
            if mapping else np.zeros(0)

    # -- transcripts --------------------------------------------------------
    def merge_supervisions(self, target_spk_supervisions):
        """Merge adjacent supervisions (gap <= max_timestamp_pause)
        (local_datasets.py:132-151). Returns [(start, end, text)]."""
        merged: List[list] = []
        for sup in sorted(target_spk_supervisions, key=lambda s: s.start):
            if merged:
                prev_end = round_nearest(merged[-1][1], 0.02)
                curr_start = round_nearest(sup.start, 0.02)
                if (prev_end == curr_start
                        or sup.start - merged[-1][1] <= self.max_timestamp_pause):
                    merged[-1][1] = sup.end
                    merged[-1][2] = merged[-1][2] + " " + (sup.text or "")
                    continue
            merged.append([sup.start, sup.end, sup.text or ""])
        return merged

    def get_segment_text_with_timestamps(self, segment, skip_end_token: bool):
        start_t, end_t, raw = segment
        text = self.text_norm(raw)
        if not text:
            return ""
        if not self.use_timestamps:
            return text
        start = f"<|{round_nearest(start_t, 0.02):.2f}|>"
        end = "" if skip_end_token else f"<|{round_nearest(end_t, 0.02):.2f}|>"
        return start + text + end

    def build_transcript(self, cut: Cut, speaker_id: str) -> str:
        last_unfinished = False
        if getattr(cut, "custom", None):
            flags = cut.custom.get("per_spk_flags") or {}
            last_unfinished = bool(flags.get(speaker_id, False))
        sups = [s for s in cut.supervisions if s.speaker == speaker_id]
        merged = self.merge_supervisions(sups)
        sep = "" if self.use_timestamps else " "
        return sep.join(
            self.get_segment_text_with_timestamps(
                seg, skip_end_token=(i == len(merged) - 1) and last_unfinished)
            for i, seg in enumerate(merged))

    # -- features / masks -----------------------------------------------------
    def get_stno_mask(self, cut: Cut, speaker_id: str) -> np.ndarray:
        speakers = cut.speakers
        speakers_to_idx = {s: i for i, s in enumerate(speakers)}
        spk_mask = cut.speakers_audio_mask(speakers_to_idx)
        spk_mask = downsample_speaker_mask(
            spk_mask, subsample_factor=self.model_features_subsample_factor)
        if speaker_id == "-1":
            spk_mask = np.pad(spk_mask, ((0, 1), (0, 0)))
            s_index = -1
        else:
            s_index = speakers_to_idx[speaker_id]
        return create_stno_mask(spk_mask, s_index)

    def get_features(self, cut: Cut):
        count("data.mel_calls")
        with span("data.features"):
            if self.load_channel_zero_only:
                samples = cut.load_audio(channels=[0])
            else:
                samples = cut.load_audio()
            samples = samples.squeeze()
            if samples.ndim > 1:  # signal sum over channels
                samples = samples.sum(axis=0)
            if (self.musan_augment is not None
                    and np.random.rand() < self.musan_augment_prob):
                samples = self.musan_augment(samples)
            return extract_features(samples, self.num_mel_bins)

    # -- enrollment selection (SE-DiCoW) ------------------------------------
    @staticmethod
    def sample_enrollment_window(arr, window_size=30, greedy_sample=False,
                                 skew_param=5.0):
        arr = np.asarray(arr, dtype=float)
        n = len(arr)
        weights = np.convolve(arr, np.ones(window_size), mode="valid")
        if greedy_sample:
            start = int(np.argmax(weights))
            return start, weights[start]
        max_start = n - window_size + 1
        weights = weights[:max_start]
        scaled = np.power(weights, skew_param)
        if np.all(weights == 0):
            raise ValueError("No speaker activity found.")
        probs = scaled / scaled.sum()
        start = int(np.random.choice(np.arange(max_start), p=probs))
        return start, weights[start]

    @staticmethod
    def downsample_mean(arr, factor=1600):
        arr = np.asarray(arr, dtype=float)
        n = len(arr) // factor
        return arr[: n * factor].reshape(n, factor).mean(axis=1)

    def get_potentionally_parent_recording(self, cut: Cut) -> Cut:
        if getattr(self, "parent_csets", None) is not None:
            rid = get_cut_recording_id(cut)
            if rid in self.parent_recording_to_id:
                return self.parent_csets[self.parent_recording_to_id[rid]]
        return cut

    def select_random_internal_enrollment(self, spk_id: str, cut: Cut,
                                          greedy_sample=False) -> Cut:
        """30 s window where the target speaker is most active, overlaps
        masked out (local_datasets.py:261-292)."""
        speakers = cut.speakers
        speakers_to_idx = {s: i for i, s in enumerate(speakers)}
        spk_mask = cut.speakers_audio_mask(speakers_to_idx)
        spk_mask = spk_mask.copy()
        spk_mask[:, spk_mask.sum(axis=0) > 1] = 0  # mask overlaps
        activity = self.downsample_mean(spk_mask[speakers_to_idx[spk_id]],
                                        int(cut.sampling_rate / 10))
        start, act = self.sample_enrollment_window(
            activity, window_size=300, greedy_sample=greedy_sample)
        if act == 0:  # fully overlapped; fall back to raw activity
            spk_mask = cut.speakers_audio_mask(speakers_to_idx)
            activity = self.downsample_mean(spk_mask[speakers_to_idx[spk_id]],
                                            int(cut.sampling_rate / 10))
            start, _ = self.sample_enrollment_window(
                activity, window_size=300, greedy_sample=greedy_sample)

        new_start = start / 10
        new_cut = replace(cut) if isinstance(cut, MonoCut) else cut
        if isinstance(cut, MonoCut):
            new_cut = replace(cut, start=cut.start + new_start, duration=30.0)
            sups = []
            for sup in cut.supervisions:
                if sup.end < new_start or sup.start > new_start + 30.0:
                    continue
                sups.append(replace(sup, start=sup.start - new_start))
            new_cut.supervisions = sups
            return new_cut
        # MixedCut: shift track offsets
        tracks = []
        for t in cut.tracks:
            tracks.append(MixTrack(cut=t.cut, offset=t.offset - new_start))
        return MixedCut(id=f"{cut.id}_enroll", tracks=tracks)

    @staticmethod
    def mix_two_recordings(len_1, len_2, allowed_pause):
        rec2_offset = np.random.uniform(
            low=-len_1 - len_2 - allowed_pause, high=allowed_pause)
        if -rec2_offset <= len_1:
            return 0, len_1 + rec2_offset
        return -(len_1 + rec2_offset), 0

    @staticmethod
    def sample_offsets(target_duration, durations, overlap_factor,
                       allowed_pause=2.0):
        n = len(durations)
        duration_to_mix = target_duration * overlap_factor
        shuffle = np.random.permutation(n)
        prev_dur = durations[shuffle[0]]
        offsets = np.zeros(n)
        for i in range(1, n):
            other = durations[shuffle[i]]
            o1, o2 = TS_ASR_DatasetSuperclass.mix_two_recordings(
                prev_dur, other, allowed_pause)
            offsets[:] += o1
            offsets[shuffle[i]] = o2
            prev_dur = max(o1 + prev_dur, o2 + other)
        if prev_dur < duration_to_mix:
            offset = np.random.uniform(0, target_duration - prev_dur)
            return 0, offsets + offset
        if np.random.choice([-1, 1]) == 1:
            return prev_dur - duration_to_mix, offsets
        return 0, offsets + (target_duration - duration_to_mix)

    def sample_same_speaker_cut(self, speaker_id, skip_ids, greedy_sample,
                                max_duration):
        speaker_cuts = self.per_speaker_enrollments[speaker_id]
        filtered = speaker_cuts.filter(
            lambda cut: not any(cut.recording_id in sid for sid in skip_ids)
            and cut.duration <= max_duration)
        if len(filtered) == 0:
            raise ValueError(
                f"No valid enrollment cuts for speaker {speaker_id} "
                f"after skipping {skip_ids}")
        weights = np.array([c.duration for c in filtered])
        if greedy_sample:
            return filtered[int(np.argmax(weights))]
        idx = np.random.choice(len(filtered), p=weights / weights.sum())
        return filtered[int(idx)]

    def generate_enrollment_mixture(self, original_cut, speaker_id,
                                    greedy_sample, max_enrollment_len=30.0,
                                    randomly_shift_target_offset_p=1.0,
                                    num_other_speakers=2,
                                    min_overlap_ratio=0.3,
                                    max_overlap_ratio=1.0):
        """Synthesize an enrollment mixture (local_datasets.py:355-436)."""
        skip_ids = []
        if isinstance(original_cut, MixedCut):
            for track in original_cut.tracks:
                skip_ids.append(re.sub("_vp.*$", "", track.cut.recording_id))
        else:
            skip_ids.append(re.sub("_vp.*$", "", original_cut.recording_id))

        same_spk = self.sample_same_speaker_cut(
            speaker_id, skip_ids, greedy_sample, max_enrollment_len)

        n_cand = min(len(self.enrollment_speakers), num_other_speakers + 1)
        candidates = list(np.random.choice(self.enrollment_speakers, n_cand,
                                           replace=False))
        others = [s for s in candidates if s != speaker_id][:num_other_speakers]
        other_cuts = [self.per_speaker_enrollments[s].sample() for s in others]
        other_lens = [c.duration for c in other_cuts]

        if other_lens:
            overlap = np.random.uniform(min_overlap_ratio, max_overlap_ratio)
            target_offset, other_offsets = self.sample_offsets(
                same_spk.duration, other_lens, overlap)
        else:
            target_offset, other_offsets = 0.0, []

        if not greedy_sample and np.random.rand() < randomly_shift_target_offset_p:
            max_other_end = max((o + l for o, l in zip(other_offsets, other_lens)),
                                default=0)
            span = max(max_other_end, same_spk.duration)
            target_offset = np.random.uniform(
                0, max(0, span - same_spk.duration))

        if same_spk.start + target_offset + same_spk.duration > max_enrollment_len:
            target_offset = max_enrollment_len - (same_spk.start + same_spk.duration)

        tracks = [MixTrack(cut=same_spk, offset=float(target_offset))]
        for cut, offset in zip(other_cuts, other_offsets):
            tracks.append(MixTrack(cut=cut, offset=float(offset)))

        final_tracks = []
        for track in tracks:
            if track.cut.duration + track.offset > max_enrollment_len:
                c = track.cut
                track = MixTrack(cut=replace(
                    c, duration=max(max_enrollment_len - track.offset, 0.0)),
                    offset=track.offset)
            if track.cut.duration > 0.0:
                final_tracks.append(track)
        return MixedCut(id=f"enrollment_{speaker_id}", tracks=final_tracks)

    def get_conditioning_cut(self, cut: Cut, speaker_id: str,
                             greedy_sample: bool) -> Cut:
        use_external = bool(getattr(cut, "custom", None)
                            and cut.custom.get("use_external_enrollment"))
        if use_external:
            if speaker_id == "-1":
                speaker_id = list(self.per_speaker_enrollments)[0]
            return self.generate_enrollment_mixture(
                cut, speaker_id, greedy_sample=greedy_sample,
                num_other_speakers=self.num_other_speakers,
                min_overlap_ratio=self.min_overlap_ratio,
                max_overlap_ratio=self.max_overlap_ratio)
        parent = self.get_potentionally_parent_recording(cut)
        return self.select_random_internal_enrollment(
            spk_id=speaker_id, cut=parent, greedy_sample=greedy_sample)

    # -- sample assembly ---------------------------------------------------
    def cut_to_sample(self, cut: Cut, speaker_id: str,
                      is_nested: bool = False) -> dict:
        stno_mask = self.get_stno_mask(cut, speaker_id)
        features, att_mask = self.get_features(cut)
        out = {
            "input_features": features,
            "stno_mask": stno_mask,
            "attention_mask": att_mask,
            "transcript": self.build_transcript(cut, speaker_id),
            "is_long_form": False,
        }
        if self.use_enrollments and not is_nested:
            other = self.get_conditioning_cut(cut, speaker_id,
                                              greedy_sample=False)
            out["enrollment"] = self.cut_to_sample(other, speaker_id,
                                                   is_nested=True)
        lang = (cut.custom or {}).get("lang") if getattr(cut, "custom", None) \
            else None
        if lang:
            out["language"] = lang
        elif self.global_lang_id:
            out["language"] = self.global_lang_id
        else:
            raise ValueError(
                "Dataset provides no lang ids; set global_lang_id.")
        return out


class TS_ASR_Dataset(TS_ASR_DatasetSuperclass):
    """(cut x speaker) indexed map-style dataset (local_datasets.py:482-501)."""

    def __len__(self):
        return int(self.to_index_mapping[-1]) if len(self.to_index_mapping) else 0

    def __getitem__(self, idx):
        if idx >= len(self):
            raise IndexError(idx)
        cut_index = int(np.searchsorted(self.to_index_mapping, idx,
                                        side="right"))
        cut = self.cset[cut_index]
        spks = cut.speakers
        local_sid = int(idx - self.to_index_mapping[cut_index]) % len(spks)
        return self.cut_to_sample(cut, spks[local_sid])


class LhotseLongFormDataset(TS_ASR_Dataset):
    """Whole-recording dataset for long-form eval; transcripts are
    "cut_id,spk_id" keys resolved against references during scoring
    (local_datasets.py:504-598)."""

    def __init__(self, cutset: CutSet, references: Optional[CutSet] = None,
                 provide_gt_lang: bool = False, break_to_characters: bool = False,
                 use_ids_as_transcripts: bool = True, **kwargs):
        self.break_to_characters = break_to_characters
        if break_to_characters:
            cutset = cutset.map(self._split_cjk_cut)
            if references is not None:
                references = references.map(self._split_cjk_cut)
        self._references = references
        super().__init__(cutsets=[cutset], **kwargs)
        if self._references is not None:
            rids = {get_cut_recording_id(c) for c in self.references}
            cids = {get_cut_recording_id(c) for c in self.cset}
            if not (rids & cids):
                raise ValueError("'references' doesn't match inference cuts")
            if rids != cids:
                logger.warning("'cutset' and 'references' aren't the same sets")
        self.provide_gt_lang = provide_gt_lang
        self.use_ids_as_transcripts = use_ids_as_transcripts

    @staticmethod
    def add_space_between_chars(text: str) -> str:
        pattern = re.compile(
            r"([ᄀ-ᇿ⺀-꓏ꡀ-힯豈-﫿"
            r"︰-﹏･-ￜ\U00020000-\U0002FFFF　-〿"
            r"！-｠฀-๿])")
        chars = [c for c in pattern.split(text) if c.strip()]
        return re.sub(r"\s+", " ", " ".join(chars))

    @classmethod
    def _split_cjk_cut(cls, cut):
        for sup in cut.supervisions:
            if sup.text:
                sup.text = cls.add_space_between_chars(sup.text)
        return cut

    @property
    def references(self) -> CutSet:
        return self._references if self._references is not None else self.cset

    def has_reference_lang(self, rec_id):
        matches = self.references.filter(
            lambda x: get_cut_recording_id(x) == rec_id)
        if len(matches) and getattr(matches[0], "custom", None):
            return matches[0].custom.get("lang", False)
        return False

    def cut_to_sample(self, cut: Cut, speaker_id: str,
                      is_nested: bool = False) -> dict:
        stno_mask = self.get_stno_mask(cut, speaker_id)
        features, att_mask = self.get_features(cut)
        out = {
            "input_features": features,
            "stno_mask": stno_mask,
            "attention_mask": att_mask,
            "transcript": f"{cut.id},{speaker_id}",
            "is_long_form": True,
        }
        if not self.use_ids_as_transcripts:
            out["transcript"] = self.build_transcript(cut, speaker_id)
        if self.provide_gt_lang and not is_nested:
            lang = (cut.custom or {}).get("lang") if getattr(cut, "custom",
                                                             None) else None
            if lang:
                out["language"] = lang
            elif self._references is not None or self.global_lang_id:
                ref_lang = self.has_reference_lang(get_cut_recording_id(cut))
                out["language"] = ref_lang or self.global_lang_id
            else:
                raise ValueError(
                    "Dataset provides no lang ids; set global_lang_id.")
        if self.use_enrollments and not is_nested:
            other = self.get_conditioning_cut(cut, speaker_id,
                                              greedy_sample=True)
            out["enrollment"] = self.cut_to_sample(other, speaker_id,
                                                   is_nested=True)
        return out


def load_cutsets(cutset_list: Sequence[str], use_enrollments: bool) -> List[CutSet]:
    """Path-convention handling (local_datasets.py:601-624): an
    '_external_enrollment' marker in the filename means enrollment mixtures
    are synthesized; '30s' cutsets get their parent full-recording cutset
    attached for internal enrollment sampling."""
    cutsets = []
    for cut_path in cutset_list:
        should_use_external = False
        if use_enrollments and "external_enrollment" in cut_path:
            cut_path = cut_path.replace("_external_enrollment", "")
            should_use_external = True
        cutset = load_manifest(cut_path)
        if use_enrollments:
            if should_use_external:
                for c in cutset:
                    c.custom = dict(c.custom or {})
                    c.custom["use_external_enrollment"] = True
            elif "30s" in cut_path:
                parent_path = cut_path.replace("_30s", "")
                if Path(parent_path).exists():
                    cutset.parent_cutset = load_manifest(parent_path)
        cutsets.append(cutset)
    return cutsets


def build_datasets(cutset_paths, data_args, text_norm, num_mel_bins,
                   diar_cutset_paths=None, enrollment_cutset=None,
                   use_ids_as_transcripts=True,
                   dataset_class=LhotseLongFormDataset):
    """Per-split long-form datasets keyed by manifest basename
    (local_datasets.py:627-669)."""
    import os

    if not cutset_paths:
        raise ValueError("'cutset_paths' is empty")
    cutsets = load_cutsets(cutset_paths, data_args.use_enrollments)
    if data_args.merge_eval_cutsets:
        cutsets = [reduce(lambda a, b: a + b, cutsets)]
        cutset_paths = ["reduced_from" + "_".join(
            os.path.basename(p) for p in cutset_paths)]
    if data_args.use_diar:
        if not diar_cutset_paths:
            raise ValueError("'diar_cutset_paths' is empty but use_diar=True")
        missing = [p for p in diar_cutset_paths
                   if not Path(p).exists()
                   and not Path(p.replace("_external_enrollment", "")).exists()]
        if missing:
            raise ValueError(f"Missing diar cutsets: {missing}")
        refs = cutsets
        cutsets = load_cutsets(diar_cutset_paths, data_args.use_enrollments)
        if data_args.merge_eval_cutsets:
            cutsets = [reduce(lambda a, b: a + b, cutsets)]
    else:
        refs = [None] * len(cutsets)

    return {
        os.path.basename(p).removesuffix(".jsonl.gz"): dataset_class(
            cutset=cutset, references=ref,
            use_timestamps=data_args.use_timestamps,
            text_norm=text_norm,
            num_mel_bins=num_mel_bins,
            global_lang_id=data_args.global_lang_id,
            provide_gt_lang=data_args.provide_gt_lang,
            load_channel_zero_only=data_args.load_channel_zero_only,
            break_to_characters="break_to_chars" in p,
            use_enrollments=data_args.use_enrollments,
            enrollment_cutset=enrollment_cutset,
            use_ids_as_transcripts=use_ids_as_transcripts,
            num_other_speakers=data_args.number_of_mixed_speakers,
            min_overlap_ratio=data_args.min_enrollment_mix_overlap,
            max_overlap_ratio=data_args.max_enrollment_mix_overlap,
        )
        for cutset, ref, p in zip(cutsets, refs, cutset_paths)
    }
