"""``training.auto_find_batch_size`` of the port under FSDP2 and a ``model``
axis, over gloo on the CPU, through ``ModelTrainer.train`` on a tiny model
and a corpus of 16 rows: the meshes [2] with ``shard_params`` (2 ranks),
[1, 2] (tensor parallelism, 2 ranks) and [2, 2] with ``shard_params``
(FSDP2 x TP, 4 ranks). The fault is raised inside one rank's first memory
probe, from a forward pre-hook on encoder layer 1: after layer 0's
all-gather (FSDP2) or row-parallel all-reduces (TP), so that a probe that
ran the real collectives would leave the other ranks waiting in the next
one. The probe replaces them by allocations
(parallel/mesh.py::local_collectives) and the ranks decide together:

- an out-of-memory error halves every rank from micro-batch 4 and
  accumulation 1 to 2 and 2, and each mesh then ends where the same mesh
  started at micro-batch 2 and accumulation 2 ends, bit for bit;
- a ValueError stops every rank, and the others' error names the failing
  rank;
- with no fault nothing halves, and the run ends where the same run
  without the option ends.

Each spawn is killed at its timeout, so a rank left waiting in a
collective fails the test instead of stalling the suite. The probe alone
and its allocations: tests/test_torch_autobatch_probe.py."""

import json

import pytest
import torch

import torch_mp_worker as W
from ts_asr_whisper_tpu_torch.data.synthetic import write_corpus

TIMEOUT = 300

# the tiny model of tests/test_torch_end_to_end.py's train_corpus
MODEL = {"vocab_size": 2000, "num_mel_bins": 80, "d_model": 128,
         "encoder_layers": 2, "decoder_layers": 2,
         "encoder_attention_heads": 2, "decoder_attention_heads": 2,
         "encoder_ffn_dim": 256, "decoder_ffn_dim": 256,
         "max_source_positions": 1500, "max_target_positions": 448}

# (mesh overrides, world)
MESHES = {
    "fsdp_2": (("training.mesh_shape=[2]", "training.shard_params=true"), 2),
    "tp_1x2": (("training.mesh_shape=[1,2]",
                "training.mesh_axis_names=[data,model]"), 2),
    "fsdp_tp_2x2": (("training.mesh_shape=[2,2]",
                     "training.mesh_axis_names=[data,model]",
                     "training.shard_params=true"), 4)}


@pytest.fixture(scope="module")
def sharded_corpus(tmp_path_factory):
    """8 two-speaker recordings of 30 s (16 rows: one global batch at
    micro-batch 4 over 4 ranks) and a model dir with only its config (the
    weights come from the seed, the same on every rank and every
    rebuild)."""
    tmp = tmp_path_factory.mktemp("torch_autobatch_sharded")
    train = write_corpus(tmp / "corpus", durations=(30.0,) * 8, seed=0)
    model_dir = tmp / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(MODEL))
    return {"model": model_dir, "train": train}


def train_overrides(corpus, out_dir, mesh, *extra):
    """The base config's fine-tune in fp32 with the augmentations off on
    ``mesh``: 4 micro-batches, the first 2 the FDDT preheat, from micro-
    batch 4 and accumulation 1 unless ``extra`` says otherwise."""
    return [f"model.whisper_model={corpus['model']}",
            f"data.train_cutsets=[{corpus['train']}]",
            "data.dev_cutsets=[]", "data.eval_cutsets=[]",
            "model.dtype=float32", "aug.stno_gaussian_noise_var=null",
            "aug.stno_gaussian_noise_prob=0.0",
            "aug.stno_segment_augment_prob=0.0", "aug.spec_aug_prob=0.0",
            "training.overall_batch_size=0",
            "training.per_device_train_batch_size=4",
            "training.gradient_accumulation_steps=1",
            "training.max_steps=4", "training.use_fddt_only_n_epochs=0",
            "training.use_fddt_only_n_steps=2", "training.warmup_steps=0",
            "training.eval_strategy=no", "training.save_strategy=no",
            "training.logging_steps=1", "training.dataloader_num_workers=1",
            *MESHES[mesh][0], f"training.output_dir={out_dir}", *extra]


def _run(corpus, out, mesh, tag, *extra, fault=None):
    return {"tag": tag, "fault": fault,
            "overrides": train_overrides(corpus, out / tag, mesh, *extra)}


def _layer1_fault(rank, error):
    return {"rank": rank, "error": error, "at": "encoder_layer1"}


def _states(out, tag, world):
    return [torch.load(out / f"{tag}{r}.pt") for r in range(world)]


def _assert_equal_states(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            assert torch.equal(g[k], v), k
    for state in got[1:]:
        for k, v in got[0].items():
            assert torch.equal(state[k], v), k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_oom_inside_one_ranks_probe_halves_every_rank(
        mesh, sharded_corpus, tmp_path):
    world = MESHES[mesh][1]
    runs = [_run(sharded_corpus, tmp_path, mesh, "auto",
                 "training.auto_find_batch_size=true",
                 fault=_layer1_fault(world - 1, "oom")),
            _run(sharded_corpus, tmp_path, mesh, "ref",
                 "training.per_device_train_batch_size=2",
                 "training.gradient_accumulation_steps=2")]
    ranks = W.spawn("autobatch", tmp_path, world, {"runs": runs},
                    timeout=TIMEOUT)
    for r in ranks:
        # the last rank's first probe failed; every rank probed again at 2
        assert r["auto"] == {"probed": [4, 2], "batch": 2, "accum": 2}
        assert r["ref"] == {"probed": [], "batch": 2, "accum": 2}
    _assert_equal_states(_states(tmp_path, "auto", world),
                         _states(tmp_path, "ref", world))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_other_error_inside_one_ranks_probe_stops_every_rank(
        mesh, sharded_corpus, tmp_path):
    world = MESHES[mesh][1]
    runs = [_run(sharded_corpus, tmp_path, mesh, "auto",
                 "training.auto_find_batch_size=true",
                 fault=_layer1_fault(1, "value"))]
    outs = W.spawn("autobatch", tmp_path, world, {"runs": runs},
                   timeout=TIMEOUT, check=False)
    assert all(rc != 0 for rc, _ in outs)
    assert "ValueError: bad batch" in outs[1][1]
    for rank, (_, out) in enumerate(outs):
        if rank != 1:
            assert "RuntimeError: auto_find_batch_size: the memory probe " \
                "failed on rank(s) [1]" in out
            assert "ValueError" not in out


def test_no_fault_no_halving_and_no_trace(sharded_corpus, tmp_path):
    mesh = "fsdp_tp_2x2"
    world = MESHES[mesh][1]
    runs = [_run(sharded_corpus, tmp_path, mesh, "auto",
                 "training.auto_find_batch_size=true"),
            _run(sharded_corpus, tmp_path, mesh, "ref")]
    ranks = W.spawn("autobatch", tmp_path, world, {"runs": runs},
                    timeout=TIMEOUT)
    for r in ranks:
        assert r["auto"] == {"probed": [4], "batch": 4, "accum": 1}
        assert r["ref"]["probed"] == []
    _assert_equal_states(_states(tmp_path, "auto", world),
                         _states(tmp_path, "ref", world))
