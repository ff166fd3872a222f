"""The port's WhisperContainer against the JAX package's: model config and
tokenizer from a model dir, random init with init_dicow's distributions,
strict safetensors load, attention-impl resolution."""

import json

import jax
import numpy as np
import pytest
import torch

import torch_parity_utils  # noqa: F401  (caps torch's threads)
from ts_asr_whisper_tpu.config import load_config
from ts_asr_whisper_tpu.models.containers import WhisperContainer as JaxContainer
from ts_asr_whisper_tpu.models.convert import params_to_hf, save_safetensors
from ts_asr_whisper_tpu_torch.models import containers as C

MODEL = {"vocab_size": 2000, "num_mel_bins": 80, "d_model": 32,
         "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_attention_heads": 2,
         "encoder_ffn_dim": 64, "decoder_ffn_dim": 64,
         "max_source_positions": 1500, "max_target_positions": 64}


def _cfg(model_dir, *extra):
    return load_config([f"model.whisper_model={model_dir}",
                        "training.decode_only=true", *extra], n_devices=1)


@pytest.fixture
def model_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(MODEL))
    return d


def test_config_and_tokenizer_match_the_jax_container(model_dir):
    cfg = _cfg(model_dir)
    tc = C.WhisperContainer(cfg, torch.device("cpu"), seed=0)
    jc = JaxContainer(cfg, seed=0)
    assert tc.model_config.__dict__ == jc.model_config.__dict__
    # the port's own copy of the byte-level tokenizer
    assert isinstance(tc.tokenizer, C.ByteLevelTokenizer)
    assert type(jc.tokenizer).__name__ == "ByteLevelTokenizer"
    assert tc.tokenizer.upper_cased_tokens == jc.tokenizer.upper_cased_tokens
    assert tc.attention_impl == "flash"


def test_hf_tokenizer_is_asked_only_when_its_files_exist(model_dir,
                                                         monkeypatch):
    asked = []
    real = C.load_tokenizer
    monkeypatch.setattr(C, "load_tokenizer",
                        lambda path, **kw: asked.append(path) or real(None,
                                                                      **kw))
    C.WhisperContainer(_cfg(model_dir), torch.device("cpu"))
    (model_dir / "tokenizer.json").write_text("{}")
    C.WhisperContainer(_cfg(model_dir), torch.device("cpu"))
    assert asked == [None, str(model_dir)]


def test_random_init_has_init_dicows_distributions(model_dir):
    cfg = _cfg(model_dir)  # base.yaml: suppressive FDDT, pre-pos FDDT 0.5
    tc = C.WhisperContainer(cfg, torch.device("cpu"), seed=0)
    jc = JaxContainer(cfg, seed=0)
    ref = params_to_hf(jax.tree.map(np.asarray, jc.params), jc.model_config)
    sd = {k: v.numpy() for k, v in tc.model.state_dict().items()}
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert sd[k].shape == v.shape, k
        deterministic = ("layer_norm" in k or "fddt" in k
                         or "encoder.embed_positions" in k)
        if deterministic:  # constants: ones, zeros, suppressive, sinusoids
            np.testing.assert_allclose(sd[k], v, atol=1e-6, err_msg=k)
        elif v.size >= 1000:  # same uniform / normal law
            assert abs(sd[k].std() - v.std()) < 0.1 * v.std(), k
            assert np.abs(sd[k]).max() <= np.abs(v).max() * 1.05 + 1e-6, k


def test_safetensors_load_strictly(model_dir):
    cfg = _cfg(model_dir)
    jc = JaxContainer(cfg, seed=5)
    save_safetensors(params_to_hf(jax.tree.map(np.asarray, jc.params),
                                  jc.model_config),
                     str(model_dir / "model.safetensors"))
    tc = C.WhisperContainer(cfg, torch.device("cpu"), seed=0)
    w = tc.model.decoder.layers[1].encoder_attn.v_proj.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        np.asarray(jc.params["decoder"]["layers"]["encoder_attn"]["v_proj"]
                   ["kernel"][1]).T)
    # a checkpoint that lacks a module of the config does not load
    save_safetensors({k: v for k, v in params_to_hf(
        jax.tree.map(np.asarray, jc.params), jc.model_config).items()
        if "initial_fddt" not in k}, str(model_dir / "model.safetensors"))
    with pytest.raises(RuntimeError, match="initial_fddt"):
        C.WhisperContainer(cfg, torch.device("cpu"))


@pytest.mark.parametrize("impl,want", [("auto", "flash"), ("pallas", "flash"),
                                       ("xla", "plain")])
def test_attention_impl_on_cpu(model_dir, impl, want):
    tc = C.WhisperContainer(_cfg(model_dir, f"model.attention_impl={impl}"),
                            torch.device("cpu"))
    assert tc.attention_impl == want
    assert tc.model.encoder.flash == (want == "flash")


def test_tpu_only_attention_impl_raises(model_dir):
    with pytest.raises(NotImplementedError, match="xla_bf16"):
        C.WhisperContainer(_cfg(model_dir, "model.attention_impl=xla_bf16"),
                           torch.device("cpu"))
