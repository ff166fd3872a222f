"""The port's process helpers and entry points over several ranks on the
CPU (gloo), after tests/test_multiprocess.py:

- parallel/dist.py's primitives across 2 live processes;
- the scope: a ``model`` mesh axis (tensor parallelism) that does not
  divide the heads, a mesh larger or smaller than the world and
  pre-training at a world above 1 are refused, each with its reason; a
  ``data`` mesh, or ``data`` x ``model``, over the world is not, nor
  ``auto_find_batch_size`` under DDP or ``shard_params``, nor LoRA under
  ``shard_params``; the default backend takes NCCL for
  CUDA tensors and fails where there is none, it never falls back to
  gloo;
- rank-sharded long-form eval through the CLI (``decode_only``): rank 0
  decodes batches 0, 2, 4 and rank 1 batches 1, 3, 5; the metrics are
  every rank's alike and equal the single-process run's and the JAX CLI's;
  only rank 0 scores and writes;
- ``torchrun -m ts_asr_whisper_tpu_torch``: the fine-tune over 2 ranks,
  DDP and FSDP2, logs the single-process run's losses, writes its metrics
  stream and HF export once, and exports the same weights."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed

import torch_mp_worker as W
import torch_parity_utils  # noqa: F401  (caps torch's threads)
from test_multiprocess import _eval_overrides, _make_eval_corpus
from test_torch_end_to_end import (MODEL, _save_weights,  # noqa: F401
                                   _train_overrides, train_corpus)
from ts_asr_whisper_tpu_torch.config import load_config as port_load_config
from ts_asr_whisper_tpu_torch.decode import check_scope
from ts_asr_whisper_tpu_torch.parallel import dist as pdist
from ts_asr_whisper_tpu_torch.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parents[1]


def test_two_process_primitives(tmp_path):
    r0, r1 = W.spawn("primitives", tmp_path, 2, {})
    for r in (r0, r1):
        assert r["world"] == 2
        assert r["broadcast"] == {"metric": 41.5, "name": "tcp_wer",
                                  "sessions": ["a", "b"],
                                  "nested": {"x": 2}}
        assert r["gathered"] == [{"rank": 0, "tag": "p0"},
                                 {"rank": 1, "tag": "p1"}]
        assert r["big_ok"] == [True, True]
    assert sorted(r0["shard"] + r1["shard"]) == list(range(10))
    assert not set(r0["shard"]) & set(r1["shard"])
    assert r0["shard"] == [0, 2, 4, 6, 8]


def test_single_process_helpers_need_no_process_group():
    assert not torch.distributed.is_initialized()
    pdist.initialize()  # no torchrun environment: a no-op
    assert not torch.distributed.is_initialized()
    assert (pdist.get_rank(), pdist.world_size()) == (0, 1)
    assert pdist.broadcast_from_main({"a": 1}) == {"a": 1}
    assert pdist.gather_from_processes(3) == [3]
    assert pdist.shard_indices_by_process(3) == [0, 1, 2]
    assert make_mesh(None) is None and make_mesh([1]) is None


def _cfg(*overrides):
    return port_load_config(["data.train_cutsets=[]", "data.dev_cutsets=[]",
                             "data.eval_cutsets=[]", *overrides],
                            n_devices=2)


@pytest.mark.parametrize("overrides, error, match", [
    (("training.mesh_shape=[1,2]", "training.mesh_axis_names=[data,model]",
      "model.whisper_model={odd_heads}"),
     NotImplementedError, "does not divide encoder_attention_heads=3"),
    (("training.mesh_shape=[4]",), ValueError, "needs 4 devices, have 2"),
    (("training.mesh_shape=[1]",), ValueError, "covers 1 of the 2 ranks"),
    (("+pretrain=turbo",), NotImplementedError, "pre-training runs on one"),
])
def test_scope_refuses_at_world_two(overrides, error, match, tmp_path):
    # a model of 3 heads: a model axis of 2 would split one
    (tmp_path / "config.json").write_text(json.dumps({
        "d_model": 192, "encoder_attention_heads": 3,
        "decoder_attention_heads": 3, "encoder_ffn_dim": 768,
        "decoder_ffn_dim": 768}))
    with pytest.raises(error, match=match):
        check_scope(_cfg(*(o.format(odd_heads=tmp_path) for o in overrides)),
                    world=2)


@pytest.mark.parametrize("overrides", [
    (), ("training.mesh_shape=[2]",), ("training.shard_params=true",),
    ("training.use_lora=true",),
    ("training.use_lora=true", "training.shard_params=true"),
    ("training.auto_find_batch_size=true",),
    ("training.auto_find_batch_size=true", "training.decode_only=true"),
    ("training.auto_find_batch_size=true", "training.shard_params=true"),
    ("training.mesh_shape=[1,2]", "training.mesh_axis_names=[data,model]"),
    ("training.mesh_shape=[2,1]", "training.mesh_axis_names=[data,model]")])
def test_scope_accepts_a_data_mesh_over_the_world(overrides):
    check_scope(_cfg(*overrides), world=2)
    # the same options on one rank, without the mesh
    check_scope(_cfg(*(o for o in overrides[:1]
                       if not o.startswith("training.mesh"))), world=1)


def test_default_backend_never_falls_back_to_gloo(tmp_path):
    if torch.distributed.is_nccl_available():
        pytest.skip("this build has NCCL: the default backend would start")
    with pytest.raises(RuntimeError, match="NCCL"):
        pdist.initialize(init_method=f"file://{tmp_path / 'pg'}",
                         world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


# -- rank-sharded long-form eval ---------------------------------------------


@pytest.fixture(scope="module")
def eval_corpus(tmp_path_factory):
    """3 recordings of 6 s, two speakers each: 6 eval batches at batch 1;
    weights that both CLIs load, sharpened so that the decode emits text."""
    tmp = tmp_path_factory.mktemp("torch_dist_eval")
    corpus = _make_eval_corpus(tmp)
    _save_weights(corpus, _eval_overrides, tmp)
    return corpus


def test_sharded_eval_matches_one_process_and_jax(eval_corpus, tmp_path):
    import main as jax_main

    def argv(out):
        return ["--device", "cpu", *_eval_overrides(eval_corpus, out)]

    multi = W.spawn("cli", tmp_path / "mp", 2,
                    {"argv": argv(tmp_path / "exp_mp")})
    single, = W.spawn("cli", tmp_path / "sp", 1,
                      {"argv": argv(tmp_path / "exp_sp")})
    ref = jax_main.main(_eval_overrides(eval_corpus, tmp_path / "exp_jax"))

    assert multi[0]["decoded_batches"] == [0, 2, 4]
    assert multi[1]["decoded_batches"] == [1, 3, 5]
    assert single["decoded_batches"] == [0, 1, 2, 3, 4, 5]
    assert multi[0]["metrics"] == multi[1]["metrics"] == single["metrics"]
    key = "eval_eval_cutset_tcp_wer"
    assert key in single["metrics"]
    assert set(single["metrics"]) <= set(ref)
    for k, v in single["metrics"].items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-6, err_msg=k)
    # rank 0 alone scored (all 6 items) and wrote the outputs
    assert multi[0]["scored"] == [6] and multi[1]["scored"] == []
    csvs = list((tmp_path / "exp_mp").rglob("all_session_wer.csv"))
    assert len(csvs) == 1
    for hyp in (tmp_path / "exp_sp").rglob("tcp_wer_hyp.json"):
        twin = tmp_path / "exp_mp" / hyp.relative_to(tmp_path / "exp_sp")
        assert json.loads(twin.read_text()) == json.loads(hyp.read_text())


# -- torchrun through the CLI ------------------------------------------------


def _cli(cmd, tmp_path, timeout=120):
    """Run ``cmd`` in its own session; the whole group is killed at the
    timeout."""
    env = {"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(REPO), "HOME": str(tmp_path),
           "TMPDIR": os.environ.get("TMPDIR", str(tmp_path))}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return err


EVAL_KEY = "eval_eval_cutset_tcp_wer"
REPLACED = ("training.per_device_train_batch_size=", "data.dev_cutsets=",
            "data.eval_cutsets=", "training.eval_strategy=",
            "training.save_strategy=")


def _train_argv(corpus, out, micro_batch):
    """The end-to-end fine-tune at ``micro_batch``, with a dev evaluation,
    a checkpoint and the best model saved at step 3 and reloaded at the
    end, and a final test evaluation (the training recordings serve as
    both sets)."""
    return [o for o in _train_overrides(corpus, out)
            if not o.startswith(REPLACED)] + [
        f"training.per_device_train_batch_size={micro_batch}",
        f"data.dev_cutsets=[{corpus['train']}]",
        f"data.eval_cutsets=[{corpus['train']}]",
        "training.eval_strategy=steps", "training.eval_steps=3",
        "training.save_strategy=steps", "training.save_steps=3",
        f"training.metric_for_best_model={EVAL_KEY}",
        "training.generation_max_length=24",
        # Adam turns the rounding noise of gradients near its eps into
        # steps of up to lr size (test_torch_train_step._train_cfgs): eps
        # 1e-6 and a preheat lr of 3x (not 100x) keep the parameters of runs
        # that sum their gradients in another order within the 1e-6
        # compared
        "training.adam_epsilon=1e-6", "training.fddt_lr_multiplier=3.0"]


@pytest.fixture(scope="module")
def single_fine_tune(train_corpus, tmp_path_factory):
    """The fine-tune in one process, at micro-batch 2."""
    out = tmp_path_factory.mktemp("single_fine_tune")
    _cli([sys.executable, "-m", "ts_asr_whisper_tpu_torch", "--device", "cpu",
          *_train_argv(train_corpus, out / "exp", 2)], out)
    return out / "exp"


@pytest.mark.parametrize("shard_params", [False, True])
def test_torchrun_fine_tune_matches_one_process(train_corpus,
                                                single_fine_tune, tmp_path,
                                                shard_params):
    from safetensors.numpy import load_file

    out = tmp_path / "exp"
    argv = [o for o in _train_argv(train_corpus, out, 1)
            if o != "training.mesh_shape=[1]"]
    err = _cli([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m", "ts_asr_whisper_tpu_torch",
                "--device", "cpu", *argv,
                f"training.shard_params={str(shard_params).lower()}"],
               tmp_path)
    assert "rank=1/2" in err and "Unfreezing at step 2" in err
    assert "Reloading best checkpoint" in err
    logs = [[json.loads(line) for line in
             (d / "metrics.jsonl").read_text().splitlines()]
            for d in (single_fine_tune, out)]
    # the training steps, then the dev evaluation at step 3, once
    assert [r["step"] for r in logs[1]] == [r["step"] for r in logs[0]] \
        == [1, 2, 3, 3]
    for r, o in zip(logs[0][:3], logs[1][:3]):
        for k in ("loss", "dec_loss", "ctc_loss"):
            np.testing.assert_allclose(o[k], r[k], rtol=1e-6, err_msg=k)
        # each rank computes on 1 row against the single run's 2: the
        # gradients (sums over 1500 frames, with cancellation) round in
        # other blockings, ~1e-5 of the norm once the encoder's layers
        # train (step 3)
        np.testing.assert_allclose(o["grad_norm"], r["grad_norm"], rtol=1e-4)
    assert logs[1][3].keys() == logs[0][3].keys() and EVAL_KEY in logs[1][3]
    for k, v in logs[0][3].items():
        if k != "time":
            np.testing.assert_allclose(logs[1][3][k], v, rtol=1e-6,
                                       err_msg=k)
    for name in ("ckpt", "ckpt_best"):
        assert sorted(p.name for p in (out / name).iterdir()) == \
            ["latest", "step_3"]
    # the final test evaluation, scored and written by rank 0 alone
    assert len(list(out.rglob("all_session_wer.csv"))) == 2
    want = load_file(str(single_fine_tune / "hf_export" /
                         "model.safetensors"))
    got = load_file(str(out / "hf_export" / "model.safetensors"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)
    assert not list(out.rglob("*.tmp"))
