"""Tokenizer layer.

Two implementations behind one duck-typed surface:

- ``load_hf_tokenizer``: the real Whisper BPE via transformers, from local
  files (``local_files_only``; this framework runs in zero-egress
  environments, the user supplies vocab files or a model dir);
- ``ByteLevelTokenizer``: a self-contained byte-level tokenizer with the
  Whisper special-token LAYOUT (eos/sot/langs/tasks/notimestamps/timestamps
  as the trailing ids) so every pipeline component — prefix tokens,
  timestamp ids, case-invariant label maps, SegLST parsing — can run and be
  tested without hub assets.

Also: ``create_lower_uppercase_mapping`` (reference
src/utils/general.py:52-67) for the case-invariant loss.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

_TS_RE = re.compile(r"<\|(\d+\.\d+)\|>")

LANGUAGES = ("en", "de", "fr", "es", "cs", "zh", "ja")  # extensible


def create_lower_uppercase_mapping(tokenizer) -> Dict[int, int]:
    """lower-token-id -> upper-token-id map (general.py:52-67)."""
    mapping: Dict[int, int] = {}
    vocab = tokenizer.get_vocab()
    for token, index in vocab.items():
        if len(token) < 1:
            continue
        if token[0] == "Ġ" and len(token) > 1:
            lower = token[0] + token[1].lower() + (token[2:] if len(token) > 2 else "")
        else:
            lower = token[0].lower() + token[1:]
        if lower != token:
            lower_index = vocab.get(lower)
            if lower_index is not None:
                mapping[lower_index] = index
    return mapping


class ByteLevelTokenizer:
    """Byte-level tokenizer with the Whisper trailing-special layout.

    id space (vocab_size V):
      [0, 256)                      byte tokens
      ...                           unused
      V-1501-1-6-2-len(langs)-2     eos
      +1                            sot
      then languages, then translate, transcribe, prev_sot, nospeech?
      V-1502                        <|notimestamps|>
      [V-1501, V)                   timestamps <|0.00|> .. <|30.00|>
    """

    def __init__(self, vocab_size: int = 2000,
                 languages: Sequence[str] = LANGUAGES):
        assert vocab_size >= 256 + 1501 + len(languages) + 8
        self.vocab_size = vocab_size
        self.timestamp_begin = vocab_size - 1501
        self.no_timestamps_token_id = self.timestamp_begin - 1
        n_specials = 2 + len(languages) + 3  # eos,sot,langs,translate,transcribe,prev
        base = self.no_timestamps_token_id - n_specials
        self.eos_token_id = base
        self.pad_token_id = base
        self.bos_token_id = base
        self.sot_token_id = base + 1
        self.decoder_start_token_id = self.sot_token_id
        self.lang_to_id = {f"<|{l}|>": base + 2 + i
                           for i, l in enumerate(languages)}
        self.translate_token_id = base + 2 + len(languages)
        self.transcribe_token_id = base + 3 + len(languages)
        self.prev_sot_token_id = base + 4 + len(languages)
        self.task_to_id = {"translate": self.translate_token_id,
                           "transcribe": self.transcribe_token_id}
        self.language = "en"
        self.task = "transcribe"
        self.predict_timestamps = True
        self.upper_cased_tokens = {
            ord(c): ord(c.upper()) for c in
            "abcdefghijklmnopqrstuvwxyz"}

    # -- vocab surface ------------------------------------------------------
    def get_vocab(self) -> Dict[str, int]:
        # built once: convert_tokens_to_ids sits on the collator hot path
        # (measured ~1 ms/batch rebuilding the 1750-entry dict per call)
        cached = getattr(self, "_vocab_cache", None)
        if cached is not None:
            return cached
        vocab = self._build_vocab()
        object.__setattr__(self, "_vocab_cache", vocab)
        return vocab

    def _build_vocab(self) -> Dict[str, int]:
        vocab = {chr(i) if i != 32 else "Ġ": i for i in range(256)}
        vocab["<|endoftext|>"] = self.eos_token_id
        vocab["<|startoftranscript|>"] = self.sot_token_id
        vocab.update(self.lang_to_id)
        vocab["<|translate|>"] = self.translate_token_id
        vocab["<|transcribe|>"] = self.transcribe_token_id
        vocab["<|notimestamps|>"] = self.no_timestamps_token_id
        for k in range(1501):
            vocab[f"<|{0.02 * k:.2f}|>"] = self.timestamp_begin + k
        return vocab

    @property
    def prefix_tokens(self) -> List[int]:
        toks = [self.sot_token_id,
                self.lang_to_id.get(f"<|{self.language}|>",
                                    self.sot_token_id + 1),
                self.task_to_id[self.task]]
        if not self.predict_timestamps:
            toks.append(self.no_timestamps_token_id)
        return toks

    def convert_tokens_to_ids(self, tokens):
        vocab = self.get_vocab()
        if isinstance(tokens, str):
            return vocab.get(tokens, self.eos_token_id)
        return [vocab.get(t, self.eos_token_id) for t in tokens]

    # -- encode / decode ------------------------------------------------------
    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in _TS_RE.finditer(text):
            ids.extend(text[pos : m.start()].encode("utf-8", "replace"))
            ids.append(self.timestamp_begin + round(float(m.group(1)) / 0.02))
            pos = m.end()
        ids.extend(text[pos:].encode("utf-8", "replace"))
        return ids

    def __call__(self, texts, padding="longest", max_length=None,
                 return_tensors=None, **kw):
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.prefix_tokens + self.encode_text(t) + [self.eos_token_id]
                for t in texts]
        if max_length:
            seqs = [s[:max_length] for s in seqs]
        maxlen = max(len(s) for s in seqs)
        ids = np.full((len(seqs), maxlen), self.pad_token_id, dtype=np.int64)
        mask = np.zeros((len(seqs), maxlen), dtype=np.int64)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids, skip_special_tokens=True,
               decode_with_timestamps=False) -> str:
        out = []
        for t in np.atleast_1d(np.asarray(ids)):
            t = int(t)
            if 0 <= t < 256:
                out.append(bytes([t]))
            elif t >= self.timestamp_begin and decode_with_timestamps:
                ts = 0.02 * (t - self.timestamp_begin)
                out.append(f"<|{ts:.2f}|>".encode())
            # special tokens / timestamps otherwise skipped
        return b"".join(out).decode("utf-8", "replace")

    def batch_decode(self, batch, **kw):
        return [self.decode(row, **kw) for row in batch]


def load_hf_tokenizer(path_or_name: str, language: Optional[str] = None,
                      task: str = "transcribe",
                      predict_timestamps: bool = True):
    from transformers import WhisperTokenizerFast

    tok = WhisperTokenizerFast.from_pretrained(
        path_or_name, local_files_only=True, language=language, task=task,
        predict_timestamps=predict_timestamps)
    tok.set_prefix_tokens(language=language, task=task,
                          predict_timestamps=predict_timestamps)
    tok.upper_cased_tokens = create_lower_uppercase_mapping(tok)
    return tok


def load_tokenizer(path_or_name: Optional[str] = None, vocab_size: int = 2000,
                   **kw):
    """HF tokenizer if local files are available, else the byte-level one."""
    if path_or_name:
        try:
            return load_hf_tokenizer(path_or_name, **kw)
        except Exception:
            pass
    tok = ByteLevelTokenizer(vocab_size=vocab_size)
    return tok
