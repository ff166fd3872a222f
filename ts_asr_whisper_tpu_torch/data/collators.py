"""Batch collation: padding, language forcing, case-invariant labels, and
train-time STNO/SpecAug augmentations.

Port of the reference's src/data/collators.py:14-242 in numpy (host side):
- features/attention/STNO padded to the batch max (padded STNO = silence);
- long-form batches get ``forced_decoder_ids`` = (sot, lang, task) per
  sample; training batches get the language written into label position 1;
- ``upp_labels`` built via the tokenizer's lower->upper token map;
- SpecAug applied JOINTLY to mel + (2x time-repeated) STNO so masks stay
  aligned (collators.py:209-214); Gaussian/segment STNO corruption simulates
  diarization errors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .augmentations import (
    SpecAug,
    stno_gaussian_noise,
    stno_soft_segment_augment,
)

SPEC_AUG_PARAMS = dict(  # collators.py:31-47
    apply_time_warp=True,
    time_warp_window=5,
    time_warp_mode="bicubic",
    apply_freq_mask=True,
    freq_mask_width_range=(0, 27),
    num_freq_mask=2,
    apply_time_mask=True,
    time_mask_width_ratio_range=(0.0, 0.05),
    num_time_mask=5,
)


def _pad_time_axis(arrs: List[np.ndarray], pad_value=0.0) -> np.ndarray:
    """Pad a list of (..., T) arrays along the last axis to the batch max."""
    max_t = max(a.shape[-1] for a in arrs)
    out = np.full((len(arrs), *arrs[0].shape[:-1], max_t), pad_value,
                  dtype=arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, ..., : a.shape[-1]] = a
    return out


@dataclass
class DataCollator:
    tokenizer: Any
    bos_token_id: int
    max_length: int = 448
    conv_subsample_factor: int = 2
    stno_gaussian_noise_var: Optional[float] = None
    stno_gaussian_noise_prob: float = 0.0
    stno_segment_augment_prob: float = 0.3
    stno_segment_change_prob: float = 0.1
    stno_min_segment_length: int = 5
    stno_max_segment_length: int = 50
    spec_aug_prob: float = 0.3
    use_enrollments: bool = False
    spec_aug: SpecAug = field(default=None)
    # pad labels up to a multiple of this so the jitted train step sees a
    # small set of static shapes (XLA recompiles per unique length)
    pad_labels_to_multiple_of: int = 32

    def __post_init__(self):
        if self.spec_aug is None:
            self.spec_aug = SpecAug(**SPEC_AUG_PARAMS)

    def __call__(self, inputs: List[Dict[str, Any]], nested: bool = False) -> dict:
        longform = [s["is_long_form"] for s in inputs]
        if len(set(longform)) != 1:
            raise ValueError("Some inputs are longform and some are not")
        in_longform = longform[0]

        enc = self.tokenizer([s["transcript"] for s in inputs],
                             padding="longest", max_length=self.max_length,
                             return_tensors="np")
        label_ids = np.asarray(enc["input_ids"])
        label_mask = np.asarray(enc["attention_mask"])

        feats = _pad_time_axis([np.asarray(s["input_features"]) for s in inputs])
        masks = _pad_time_axis([np.asarray(s["attention_mask"]) for s in inputs])

        stno = _pad_time_axis(
            [np.asarray(s["stno_mask"]).T for s in inputs])  # (B, 4, T)
        for i, s in enumerate(inputs):
            orig_len = np.asarray(s["stno_mask"]).shape[0]
            stno[i, 0, orig_len:] = 1.0  # padding is silence

        batch = {"input_features": feats.astype(np.float32),
                 "attention_mask": masks,
                 "stno_mask": stno.astype(np.float32)}

        languages = [s.get("language") for s in inputs]
        if all(languages):
            lang_tokens = [f"<|{l}|>" for l in languages]
            langs = self.tokenizer.convert_tokens_to_ids(lang_tokens)
            if in_longform:
                prefix = self.tokenizer.prefix_tokens
                batch["forced_decoder_ids"] = np.asarray(
                    [[prefix[0], lang, prefix[2]] for lang in langs],
                    dtype=np.int64)
            else:
                label_ids[:, 1] = np.asarray(langs)
        elif any(languages):
            raise ValueError("Some inputs have language and some do not.")

        labels = np.where(label_mask != 1, -100, label_ids)
        if (labels[:, 0] == self.bos_token_id).all():
            labels = labels[:, 1:]
        upper_map = getattr(self.tokenizer, "upper_cased_tokens", {})
        upp = labels.copy()
        if upper_map:
            flat = upp.reshape(-1)
            for i, v in enumerate(flat):
                if int(v) in upper_map:
                    flat[i] = upper_map[int(v)]
            upp = flat.reshape(labels.shape)
        if self.pad_labels_to_multiple_of and not in_longform:
            t = labels.shape[1]
            target = -(-t // self.pad_labels_to_multiple_of) \
                * self.pad_labels_to_multiple_of
            if target > t:
                pad = np.full((labels.shape[0], target - t), -100,
                              dtype=labels.dtype)
                labels = np.concatenate([labels, pad], axis=1)
                upp = np.concatenate([upp, pad], axis=1)
        batch["labels"] = labels
        batch["upp_labels"] = upp

        if not in_longform and not nested:
            if (self.stno_segment_augment_prob
                    and np.random.rand() < self.stno_segment_augment_prob):
                batch["stno_mask"] = stno_soft_segment_augment(
                    batch["stno_mask"],
                    change_prob=self.stno_segment_change_prob,
                    min_seg_len=self.stno_min_segment_length,
                    max_seg_len=self.stno_max_segment_length)
            if self.stno_gaussian_noise_var:
                batch["stno_mask"] = stno_gaussian_noise(
                    batch["stno_mask"], self.stno_gaussian_noise_var,
                    self.stno_gaussian_noise_prob)
            if np.random.rand() < self.spec_aug_prob:
                # joint SpecAug on [mel ; STNO repeated 2x in time]
                stno_up = np.repeat(batch["stno_mask"],
                                    self.conv_subsample_factor, axis=2)
                joint = np.concatenate(
                    [batch["input_features"], stno_up], axis=1)
                joint = self.spec_aug(joint.transpose(0, 2, 1)).transpose(0, 2, 1)
                n_mels = batch["input_features"].shape[1]
                batch["input_features"] = joint[:, :n_mels]
                stno_out = joint[:, n_mels:]
                b, c, t2 = stno_out.shape
                batch["stno_mask"] = stno_out.reshape(
                    b, c, t2 // self.conv_subsample_factor,
                    self.conv_subsample_factor).mean(axis=-1)

        if self.use_enrollments and not nested:
            enrollments = [s["enrollment"] for s in inputs]
            nested_batch = self(enrollments, nested=True)
            batch["enroll_features"] = nested_batch["input_features"]
            batch["enroll_stno"] = nested_batch["stno_mask"]
        return batch


@dataclass
class DataCollatorForPretraining(DataCollator):
    """Pretrain collator (collators.py:225-242): no STNO, no language
    forcing, labels only."""

    def __call__(self, inputs: List[Dict[str, Any]]) -> dict:
        enc = self.tokenizer([s["transcript"] for s in inputs],
                             padding="longest", max_length=self.max_length,
                             return_tensors="np")
        label_ids = np.asarray(enc["input_ids"])
        label_mask = np.asarray(enc["attention_mask"])
        feats = _pad_time_axis([np.asarray(s["input_features"]) for s in inputs])
        masks = _pad_time_axis([np.asarray(s["attention_mask"]) for s in inputs])
        labels = np.where(label_mask != 1, -100, label_ids)
        if (labels[:, 0] == self.bos_token_id).all():
            labels = labels[:, 1:]
        return {"input_features": feats.astype(np.float32),
                "attention_mask": masks, "labels": labels}
