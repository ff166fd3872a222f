"""Text normalizers for WER scoring.

Mirrors the reference's src/txt_norm/__init__.py:13-19:
- 'whisper'      -> the Whisper EnglishTextNormalizer, vendored in
                    whisper_en.py (byte-identical to the transformers
                    implementation, fuzz-tested) with the tysto UK->US
                    spelling list (english.json) loaded by default exactly
                    as the reference does — scoring is hermetic and does not
                    drift with installed library versions;
- 'whisper_nsf'  -> the CHiME-8/NOTSOFAR English normalizer (reverse number
                    spelling, filler removal, contraction expansion) —
                    reimplemented in nsf.py, using the vendored
                    english.json/pre_english.json by default;
- anything else  -> identity.

``spelling_mapping_path`` or the TSAW_SPELLING_JSON / TSAW_PRE_SPELLING_JSON
env vars override the vendored spelling assets.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

_ASSET_DIR = os.path.dirname(__file__)


def _load_spelling(path: Optional[str], env_var: str,
                   default_asset: str) -> Dict[str, str]:
    path = path or os.environ.get(env_var) \
        or os.path.join(_ASSET_DIR, default_asset)
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def get_text_norm(t_norm: Optional[str],
                  spelling_mapping_path: Optional[str] = None
                  ) -> Callable[[str], str]:
    if t_norm == "whisper":
        from .whisper_en import WhisperTextNormalizer

        mapping = _load_spelling(spelling_mapping_path,
                                 "TSAW_SPELLING_JSON", "english.json")
        return WhisperTextNormalizer(mapping)
    if t_norm == "whisper_nsf":
        from .nsf import NsfEnglishTextNormalizer

        return NsfEnglishTextNormalizer()
    return lambda x: x
