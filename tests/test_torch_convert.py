"""``state_dict_from_jax`` (no jax) against the JAX package's
``params_to_hf``, key for key and value for value, and strict loading into
the port's module tree."""

import jax
import numpy as np
import pytest
import torch

from torch_parity_utils import DICOW, TINY
from ts_asr_whisper_tpu.models.config import DiCoWConfig as JaxConfig
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu.models.dicow import init_dicow
from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
from ts_asr_whisper_tpu_torch.models.convert import (
    load_safetensors_dir,
    normalize_state_dict,
    state_dict_from_jax,
)
from ts_asr_whisper_tpu_torch.models.dicow import DiCoW

VARIANTS = {
    "diagonal": {},
    "full": {"fddt_is_diagonal": False},
    "bias_only": {"fddt_bias_only": True},
    "ctc_extra_layer": {"additional_layer": True,
                        "additional_self_attention_layer": False,
                        "pre_ctc_sub_sample": False},
    "no_ctc_head": {"ctc_weight": 0.0},
    "disabled_classes": {"fddt_use_silence": False,
                         "fddt_use_overlap": False},
}


def _params(overrides):
    kw = {**TINY, **DICOW, **overrides}
    jcfg = JaxConfig(**kw)
    params = jax.tree.map(np.asarray,
                          init_dicow(jax.random.PRNGKey(3), jcfg))
    return jcfg, params, DiCoWConfig(**kw)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dict_matches_params_to_hf(variant):
    jcfg, params, tcfg = _params(VARIANTS[variant])
    ref = params_to_hf(params, jcfg)
    sd = state_dict_from_jax(params, tcfg)
    assert list(sd) == list(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    # the port's module tree has exactly these keys
    DiCoW(tcfg).load_state_dict(sd, strict=True)


def test_safetensors_round_trip(tmp_path):
    jcfg, params, tcfg = _params({})
    save_safetensors(params_to_hf(params, jcfg),
                     str(tmp_path / "model.safetensors"))
    sd = normalize_state_dict(load_safetensors_dir(str(tmp_path)))
    model = DiCoW(tcfg)
    model.load_state_dict(sd, strict=True)
    w = model.encoder.layers[1].fc1.weight.detach().numpy()
    np.testing.assert_array_equal(
        w, np.asarray(params["encoder"]["layers"]["fc1"]["kernel"][1]).T)
    # proj_out stays tied to embed_tokens after the load
    assert model.proj_out.weight is model.decoder.embed_tokens.weight


def test_normalize_adds_prefix_and_tied_head():
    sd = {"encoder.conv1.weight": torch.zeros(1),
          "decoder.embed_tokens.weight": torch.ones(2)}
    out = normalize_state_dict(sd)
    assert set(out) == {"model.encoder.conv1.weight",
                        "model.decoder.embed_tokens.weight",
                        "proj_out.weight"}
    assert out["proj_out.weight"] is sd["decoder.embed_tokens.weight"]
