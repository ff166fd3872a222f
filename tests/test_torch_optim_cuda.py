"""The fine-tune's multi-tensor kernels (kernels/csrc/adamw_multi.cu) against
their plain versions on the card: ``adamw_multi`` against ``AdamW``'s
per-leaf loop on the same leaves and the same norm, bit for bit, over ~480
ragged leaves in both learning-rate groups, with the clip on, off and on a
NaN norm, fp32 and bf16 first moments, bf16 parameters, fp32 gradients on
bf16 parameters (MultiSteps' running mean) and leaves without a gradient;
more leaves than one launch takes; the table following parameters
reassigned. ``sq_norm_multi`` against ``_sq_sum`` and against itself. No
host sync in a whole ``train_step`` of a small DiCoW but those of PyTorch's
CTC loss. Skips without a GPU;
run there with ``python -m pytest tests/test_torch_optim_cuda.py -m cuda``."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from ts_asr_whisper_tpu_torch.config import load_config
from ts_asr_whisper_tpu_torch.kernels import launch_counts
from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
from ts_asr_whisper_tpu_torch.models.dicow import build_dicow
from ts_asr_whisper_tpu_torch.ops.ctc import ctc_loss_from_padded_labels
from ts_asr_whisper_tpu_torch.training import optim as TO
from ts_asr_whisper_tpu_torch.training import trainer as TT
from ts_asr_whisper_tpu_torch.utils import observability as OBS

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
# (parameter, gradient, first-moment ``adam_mu_dtype``)
DTYPES = {"fp32": (F32, F32, None), "mu_bf16": (F32, F32, "bfloat16"),
          "p_bf16": (BF16, BF16, None),
          "p_bf16_multisteps": (BF16, F32, "float32")}
# the norm handed to the update: above max_grad_norm (1.0), below, NaN
NORMS = {"clip": 4.0, "no_clip": 0.25, "nan": float("nan")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _sizes(rng, n: int, high: int = 40000) -> list:
    """``n`` ragged leaf sizes: one element (an SCB gate), odd and prime
    sizes, around a block's 16,384 elements, layer-norm widths, and the
    turbo encoder's largest leaves."""
    fixed = [1, 2, 3, 5, 7, 127, 1280, 1281, 4099, 16383, 16384, 16385,
             65537, 1280 * 1280, 1280 * 5120 + 3]
    return fixed + rng.integers(1, high, size=n - len(fixed)).tolist()


def _pair(dev, case: str, n: int = 480, seed: int = 0, high: int = 40000):
    """(kernel optimizer, plain optimizer) over equal leaves, a third of
    them in the preheat group (lr x 10), weight decay on."""
    p_dt, _, mu_dt = DTYPES[case]
    cfg = dataclasses.replace(
        load_config([], n_devices=1).training, learning_rate=1e-3,
        warmup_steps=0, max_steps=10, weight_decay=0.01, adam_mu_dtype=mu_dt)
    rng = np.random.default_rng(seed)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(dev, p_dt) for s in _sizes(rng, n, high)]
    out = []
    for _ in range(2):
        ps = [torch.nn.Parameter(t.clone()) for t in leaves]
        out.append(TO.AdamW({"preheat": ps[:n // 3], "base": ps[n // 3:]},
                            cfg, 10.0))
    kernel, plain = out
    assert kernel.table is not None
    plain.table = None  # the loop on the card: the reference
    return kernel, plain


def _grads(tx, case: str, rng, none_every: int = 7) -> list:
    g_dt = DTYPES[case][1]
    return [None if i % none_every == 3 else torch.from_numpy(
        rng.standard_normal(p.numel()).astype(np.float32) * 0.1).to(
        p.device, g_dt) for i, p in enumerate(tx.params)]


def _assert_same(kernel, plain) -> None:
    for i, (a, b) in enumerate(zip(kernel.params, plain.params)):
        for x, y, what in ((a, b, "p"), (kernel.mu[i], plain.mu[i], "mu"),
                           (kernel.nu[i], plain.nu[i], "nu")):
            assert x.dtype == y.dtype, (i, what)
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                       msg=f"leaf {i} {what}")


@pytest.mark.parametrize("norm", sorted(NORMS))
@pytest.mark.parametrize("case", sorted(DTYPES))
def test_adamw_multi_equals_the_plain_loop(cuda, case, norm):
    """Three updates on the same gradients (every 7th leaf without one) and
    the same norm: parameters and both moments bit for bit, one launch an
    update."""
    kernel, plain = _pair(cuda, case)
    rng = np.random.default_rng(1)
    g_norm = torch.tensor(NORMS[norm], device=cuda)
    for _ in range(3):
        grads = _grads(kernel, case, rng)
        before = launch_counts["adamw_multi"]
        kernel.step(grads, g_norm=g_norm)
        plain.step(grads, g_norm=g_norm)
        torch.cuda.synchronize()
        assert launch_counts["adamw_multi"] == before + 1
        _assert_same(kernel, plain)
    assert kernel.mu[0].data_ptr() == kernel.table.addresses[len(
        kernel.params)]  # the moments stay where the table points


def test_adamw_multi_over_more_leaves_than_a_launch_takes(cuda):
    """1,700 small leaves take three launches (768 a launch), equal to the
    loop; the norm computed inside the step by the norm kernel."""
    kernel, plain = _pair(cuda, "fp32", n=1700, high=3000)
    rng = np.random.default_rng(2)
    for _ in range(2):
        grads = _grads(kernel, "fp32", rng)
        g_norm = OBS.global_norm(grads)
        before = launch_counts["adamw_multi"]
        kernel.step(grads)
        plain.step(grads, g_norm=g_norm)
        torch.cuda.synchronize()
        assert launch_counts["adamw_multi"] == before + 3
        _assert_same(kernel, plain)


def test_adamw_multi_follows_parameters_reassigned(cuda):
    """A reload by assignment (``p.data = ...``) moves parameters: the next
    update rebuilds the table, writes the new tensors and leaves the old
    ones alone."""
    kernel, plain = _pair(cuda, "fp32", n=64, high=5000)
    rng = np.random.default_rng(3)
    g_norm = torch.tensor(2.0, device=cuda)
    grads = _grads(kernel, "fp32", rng)
    kernel.step(grads, g_norm=g_norm)
    plain.step(grads, g_norm=g_norm)
    old = [p.data for p in kernel.params[::5]]
    kept = [t.clone() for t in old]
    for tx in (kernel, plain):
        for p in tx.params[::5]:
            p.data = p.data.clone() * 0.5
    addresses = list(kernel.table.addresses)
    grads = _grads(kernel, "fp32", rng)
    kernel.step(grads, g_norm=g_norm)
    plain.step(grads, g_norm=g_norm)
    torch.cuda.synchronize()
    assert kernel.table.addresses != addresses
    assert kernel.table.addresses[:len(kernel.params)] == [
        p.data_ptr() for p in kernel.params]
    for t, k in zip(old, kept):
        assert torch.equal(t, k)
    _assert_same(kernel, plain)


def _parts(dev, rng, n_parts: int, per_part: int) -> list:
    """Lists of (tensor, TP-sharded) pairs of ragged sizes, fp32 and bf16
    mixed, flags mixed."""
    parts = []
    for _ in range(n_parts):
        sizes = _sizes(rng, per_part, 30000)
        parts.append([(torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev, BF16 if i % 3 == 0 else F32), i % 4 == 1)
            for i, s in enumerate(sizes)])
    return parts


@pytest.mark.parametrize("n_parts,per_part", [(1, 480), (3, 40), (2, 900)])
def test_sq_norm_multi_matches_the_plain_sums(cuda, n_parts, per_part):
    """Each part's sharded and whole sums within 1e-5 of ``_sq_sum``'s, an
    empty sum 0, the same bits on a second run; 1,800 leaves take three
    launches (768 a launch) over one scratch."""
    from ts_asr_whisper_tpu_torch.ops.multi_tensor import limits, sq_norm_multi

    parts = _parts(cuda, np.random.default_rng(n_parts), n_parts, per_part)
    parts.append([])  # a module without gradients
    before = launch_counts["sq_norm_multi"]
    out = sq_norm_multi(parts, cuda)
    again = sq_norm_multi(parts, cuda)
    calls = -(-n_parts * per_part // limits()[1])
    assert launch_counts["sq_norm_multi"] == before + 2 * calls
    assert torch.equal(out, again)
    for i, part in enumerate(parts):
        for row, flag in ((0, True), (1, False)):
            ref = OBS._sq_sum([t for t, f in part if f is flag])
            want = 0.0 if ref is None else float(ref)
            np.testing.assert_allclose(float(out[row, i]), want, rtol=1e-5,
                                       err_msg=f"part {i} sharded {flag}")


def test_global_norm_routes_to_the_kernel(cuda):
    """``global_norm`` and ``module_grad_norms`` of CUDA tensors: one launch
    each, within 1e-5 of the plain sums."""
    rng = np.random.default_rng(4)
    ts = [t for t, _ in _parts(cuda, rng, 1, 100)[0]]
    before = launch_counts["sq_norm_multi"]
    norm = OBS.global_norm(ts + [None])
    assert launch_counts["sq_norm_multi"] == before + 1
    np.testing.assert_allclose(float(norm), float(OBS._sq_sum(ts).sqrt()),
                               rtol=1e-5)
    model = torch.nn.Sequential(torch.nn.Linear(64, 96), torch.nn.ReLU(),
                                torch.nn.Linear(96, 8)).to(cuda)
    model(torch.randn(4, 64, device=cuda)).square().sum().backward()
    named = list(model.named_parameters())
    norms = OBS.module_grad_norms(named)
    assert launch_counts["sq_norm_multi"] == before + 2
    for key, idx in (("grad_norm/0.weight", 0), ("grad_norm/2.bias", 3)):
        np.testing.assert_allclose(float(norms[key]), float(
            named[idx][1].grad.norm()), rtol=1e-5, err_msg=key)


# a small DiCoW of the fine-tune's kind: bf16 compute over fp32 parameters,
# FDDTs, the CTC head with its extra self-attention layer; head dim 64 and
# 300 encoder positions put the encoder on the flash kernels
TINY = dict(
    vocab_size=2000, num_mel_bins=80, d_model=128, encoder_layers=2,
    decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=300,
    max_target_positions=64, decoder_start_token_id=1998, eos_token_id=1997,
    pad_token_id=1997, bos_token_id=1997, use_fddt=True,
    fddt_is_diagonal=True, use_pre_pos_fddt=True, non_target_fddt_value=0.5,
    additional_self_attention_layer=True, pre_ctc_sub_sample=True,
    dtype="bfloat16")


def _small_trainer(dev, tmp_path, ctc_weight: float):
    model = build_dicow(DiCoWConfig(**TINY, ctc_weight=ctc_weight), dev,
                        seed=0, flash=True)
    cfg = load_config([
        "model.dtype=bfloat16", "training.use_fddt_only_n_steps=0",
        "training.use_fddt_only_n_epochs=0", "training.max_steps=4",
        "training.warmup_steps=0", "training.eval_strategy=no",
        "training.save_strategy=no", "training.mesh_shape=[1]",
        "training.gradient_accumulation_steps=1",
        "model.params_to_keep_frozen_keywords=[decoder]",
        f"training.output_dir={tmp_path}"], n_devices=1)
    rng = np.random.default_rng(5)
    raw = rng.random((2, 4, 300)).astype(np.float32)
    labels = rng.integers(0, 1990, (2, 24))
    labels[:, :3] = [1994, 1995, 1996]
    labels[1, 18:] = -100
    batch = TT.to_device({
        "input_features": rng.standard_normal((2, 80, 600)).astype(
            np.float32),
        "stno_mask": raw / raw.sum(axis=1, keepdims=True),
        "labels": labels, "upp_labels": labels}, dev)
    return TT.Trainer(cfg, model, num_prefix_tokens=2), batch


def _syncs(fn) -> int:
    """The synchronising operations ``fn`` runs, as PyTorch's sync debug
    mode counts them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3])
def test_train_step_does_not_wait_for_the_card(cuda, tmp_path, ctc_weight):
    """A whole ``train_step``, the gradient norm and the update with its
    clip included, never waits for the card: under
    ``set_sync_debug_mode('error')`` without the CTC head. With it, the
    step's only syncs are those of PyTorch's CUDA CTC loss (``F.ctc_loss``
    copies its lengths to the host and its lengths and offsets to the card,
    forward and backward): as many as that loss alone makes."""
    trainer, batch = _small_trainer(cuda, tmp_path, ctc_weight)
    trainer.train_step(batch)  # builds the kernels, fills the allocator
    torch.cuda.synchronize()
    before = (launch_counts["adamw_multi"], launch_counts["sq_norm_multi"])
    if ctc_weight == 0:
        torch.cuda.set_sync_debug_mode("error")
        try:
            parts = trainer.train_step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    else:
        out = {}
        step = _syncs(lambda: out.update(trainer.train_step(batch)))
        parts = out
        logits = torch.randn(2, 150, 2001, device=cuda, requires_grad=True)
        labels = torch.randint(0, 1990, (2, 12), device=cuda)
        labels[1, 8:] = -100
        alone = _syncs(lambda: ctc_loss_from_padded_labels(
            logits, labels, blank_id=2000).backward())
        assert step == alone > 0
    assert (launch_counts["adamw_multi"], launch_counts["sq_norm_multi"]) \
        == (before[0] + 1, before[1] + 1)
    assert trainer.tx.count == 2
    assert np.isfinite(float(parts["grad_norm"]))
