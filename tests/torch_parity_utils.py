"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
one tiny DiCoW built by the JAX package's ``init_dicow`` and bridged into the
port with ``state_dict_from_jax``, so both sides run the same weights."""

import jax
import numpy as np
import torch

from ts_asr_whisper_tpu.models.config import DiCoWConfig as JaxConfig
from ts_asr_whisper_tpu.models.dicow import init_dicow
from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig as TorchConfig
from ts_asr_whisper_tpu_torch.models.convert import state_dict_from_jax
from ts_asr_whisper_tpu_torch.models.dicow import DiCoW

torch.set_num_threads(2)

# d_model 128 over 2 heads keeps the kernel's head dim (64); 300 encoder
# positions put the encoder's attention on the flash dispatch (T >= 256)
TINY = dict(
    vocab_size=2000, num_mel_bins=80, d_model=128, encoder_layers=2,
    decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=300,
    max_target_positions=64, decoder_start_token_id=1998, eos_token_id=1997,
    pad_token_id=1997, bos_token_id=1997,
)

DICOW = dict(
    ctc_weight=0.3, use_fddt=True, fddt_is_diagonal=True,
    fddt_bias_only=False, use_pre_pos_fddt=True, non_target_fddt_value=0.5,
    fddt_init="random", additional_self_attention_layer=True,
    pre_ctc_sub_sample=True, dtype="float32",
)


def make_pair(seed=0, **overrides):
    """(jax cfg, jax params, torch cfg, torch model) with identical weights."""
    kw = {**TINY, **DICOW, **overrides}
    jcfg = JaxConfig(**kw)
    params = init_dicow(jax.random.PRNGKey(seed), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    tcfg = TorchConfig(**kw)
    model = DiCoW(tcfg, flash=True)
    model.load_state_dict(state_dict_from_jax(params_np, tcfg), strict=True)
    return jcfg, params, tcfg, model.eval()


def encoder_inputs(rng, b=2, t_enc=300, n_mels=80):
    feats = rng.standard_normal((b, n_mels, 2 * t_enc)).astype(np.float32)
    raw = rng.random((b, 4, t_enc)).astype(np.float32)
    return feats, raw / raw.sum(axis=1, keepdims=True)

