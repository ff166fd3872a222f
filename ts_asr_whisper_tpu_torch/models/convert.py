"""Weight bridge of the port: the JAX package's param pytree (numpy leaves)
-> an HF-named torch ``state_dict``, and a local safetensors loader.

The reverse of ts_asr_whisper_tpu/models/convert.py's ``hf_to_params`` and
the same mapping as its ``params_to_hf``, without jax: linear kernels
(in, out) -> (out, in); conv kernels (k, C_in, C_out) -> (C_out, C_in, k);
layer-norm ``scale`` -> ``weight``; the leading layer axis of the stacked
layers is split into ``layers.{i}``. ``lora_state_dict_from_jax`` carries
the JAX package's LoRA tree across the same way.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import DiCoWConfig

_ATTN_KEYS = ("q_proj", "k_proj", "v_proj", "out_proj")


def _lin(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _ln(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv(out, prefix, p):
    out[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(2, 1, 0)
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _attn(out, prefix, p):
    for k in _ATTN_KEYS:
        _lin(out, f"{prefix}.{k}", p[k])


def _enc_layer(out, prefix, p):
    _attn(out, f"{prefix}.self_attn", p["self_attn"])
    _ln(out, f"{prefix}.self_attn_layer_norm", p["self_attn_layer_norm"])
    _lin(out, f"{prefix}.fc1", p["fc1"])
    _lin(out, f"{prefix}.fc2", p["fc2"])
    _ln(out, f"{prefix}.final_layer_norm", p["final_layer_norm"])


def _dec_layer(out, prefix, p):
    _enc_layer(out, prefix, p)
    _attn(out, f"{prefix}.encoder_attn", p["encoder_attn"])
    _ln(out, f"{prefix}.encoder_attn_layer_norm", p["encoder_attn_layer_norm"])


def _fddt(out, prefix, p, cfg: DiCoWConfig):
    for cls, cp in p.items():
        if cfg.fddt_bias_only:
            out[f"{prefix}.{cls}_linear"] = np.asarray(cp["bias"])
        else:
            out[f"{prefix}.{cls}_linear.weight"] = np.asarray(cp["weight"])
            if "bias" in cp:
                out[f"{prefix}.{cls}_linear.bias"] = np.asarray(cp["bias"])


def _unstack(tree) -> list:
    """Split the leading layer axis of a nested dict of arrays."""
    def first_leaf(t):
        return first_leaf(next(iter(t.values()))) if isinstance(t, Mapping) \
            else t

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, Mapping) else np.asarray(t)[i]

    return [take(tree, i) for i in range(np.asarray(first_leaf(tree)).shape[0])]


def state_dict_from_jax(params: Mapping[str, Any], cfg: DiCoWConfig,
                        prefix: str = "model.") -> Dict[str, torch.Tensor]:
    """JAX-package params (numpy or array-like leaves) -> HF-named torch
    state dict, key for key the dict that ``params_to_hf`` writes."""
    out: Dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]
    e, d = f"{prefix}encoder", f"{prefix}decoder"

    _conv(out, f"{e}.conv1", enc["conv1"])
    _conv(out, f"{e}.conv2", enc["conv2"])
    out[f"{e}.embed_positions.weight"] = np.asarray(enc["embed_positions"])
    for i, lp in enumerate(_unstack(enc["layers"])):
        _enc_layer(out, f"{e}.layers.{i}", lp)
    _ln(out, f"{e}.layer_norm", enc["layer_norm"])
    if "fddts" in enc:
        for i, fp in enumerate(_unstack(enc["fddts"])):
            _fddt(out, f"{e}.fddts.{i}", fp, cfg)
    if "initial_fddt" in enc:
        _fddt(out, f"{e}.initial_fddt", enc["initial_fddt"], cfg)
    if "lm_head" in enc:
        _lin(out, f"{e}.lm_head", enc["lm_head"])
    if "additional_layer" in enc:
        _enc_layer(out, f"{e}.additional_layer", enc["additional_layer"])
    if "additional_self_attention_layer" in enc:
        _attn(out, f"{e}.additional_self_attention_layer",
              enc["additional_self_attention_layer"])
    for conv in ("subsample_conv1", "subsample_conv2"):
        if conv in enc:
            _conv(out, f"{e}.{conv}", enc[conv])
    if "ca_enrolls" in enc:
        # SE-DiCoW SCBs (convert.py:238-243)
        for i, sp in enumerate(_unstack(enc["ca_enrolls"])):
            pre = f"{e}.ca_enrolls.{i}.cae"
            _attn(out, f"{pre}.cross_attn", sp["cross_attn"])
            _lin(out, f"{pre}.ffn.0", sp["ffn_0"])
            _lin(out, f"{pre}.ffn.3", sp["ffn_3"])
            out[f"{pre}.cross_gate.gate"] = np.asarray(sp["gate"])

    out[f"{d}.embed_tokens.weight"] = np.asarray(dec["embed_tokens"])
    out[f"{d}.embed_positions.weight"] = np.asarray(dec["embed_positions"])
    for i, lp in enumerate(_unstack(dec["layers"])):
        _dec_layer(out, f"{d}.layers.{i}", lp)
    _ln(out, f"{d}.layer_norm", dec["layer_norm"])
    out["proj_out.weight"] = np.asarray(dec["embed_tokens"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def lora_state_dict_from_jax(lora: Mapping[str, Any],
                             prefix: str = "model."
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's LoRA tree (training/lora.py::init_lora; numpy or
    array-like leaves) -> the port's adapter parameters
    (training/lora.py): ``<prefix>decoder.layers.{i}.<attn>.<proj>.lora_A``
    (r, in) and ``.lora_B`` (out, r), from A (L, in, r) and B (L, r, out)
    with the layer axis split."""
    out: Dict[str, np.ndarray] = {}
    for scope, tree in lora.items():
        for attn, projs in tree["layers"].items():
            for proj, ab in projs.items():
                a, b = np.asarray(ab["lora_A"]), np.asarray(ab["lora_B"])
                for i in range(a.shape[0]):
                    pre = f"{prefix}{scope}.layers.{i}.{attn}.{proj}"
                    out[f"{pre}.lora_A"] = a[i].T
                    out[f"{pre}.lora_B"] = b[i].T
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Load one .safetensors file or merge a directory of shards."""
    from safetensors.torch import load_file

    p = Path(path)
    files = sorted(p.glob("*.safetensors")) if p.is_dir() else [p]
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(str(f)))
    return sd


def normalize_state_dict(sd: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Bring a Whisper/DiCoW state dict to the ``DiCoW`` module's keys:
    bare ``encoder.`` / ``decoder.`` prefixes gain ``model.``, and a missing
    ``proj_out.weight`` is the tied ``embed_tokens``."""
    out = {}
    for k, v in sd.items():
        if k.startswith(("encoder.", "decoder.")):
            k = "model." + k
        out[k] = v
    if "proj_out.weight" not in out \
            and "model.decoder.embed_tokens.weight" in out:
        out["proj_out.weight"] = out["model.decoder.embed_tokens.weight"]
    return out
