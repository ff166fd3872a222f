"""Multi-process worker of the port's data- and tensor-parallel tests
(tests/test_torch_dist.py, test_torch_ddp.py, test_torch_fsdp.py,
test_torch_tp.py, test_torch_autobatch_*.py), after tests/mp_worker.py. Not collected by pytest; run
as

    python tests/torch_mp_worker.py MODE OUTDIR INIT_FILE RANK WORLD ARGS_JSON

Each worker blocks jax and the JAX package (the port needs neither), caps
torch at one thread, joins a gloo process group through the shared file
INIT_FILE (``file://``, so no port is needed) unless WORLD is 1, runs MODE
and writes ``rank<RANK>.json`` into OUTDIR. Modes:

- ``primitives``: barrier, broadcast_from_main of a nested object,
  gather_from_processes (small and uneven ~100k / 200k character
  payloads), shard_indices_by_process;
- ``train``: the port's Trainer on the tiny DiCoW of ARGS_JSON's weights
  over its data coordinate's rows of each global batch (DDP, or FSDP2
  under ``training.shard_params``; a ``model`` mesh axis slices the model,
  and model coordinate 0 hands each batch to its peers); the logged
  metrics and the final whole state dict (``state<RANK>.pt``); optionally
  a checkpoint saved and restored into a fresh sliced and wrapped model
  (``restored<RANK>.pt``);
- ``resume``: a fresh model loads a checkpoint's parameters and the
  Trainer slices and wraps it on this run's mesh; its whole state dict
  (``resumed<RANK>.pt``);
- ``tp_modules``: an ``Attention``, an ``EncoderLayer``, a decoder layer
  and an SCB sliced over the world as one ``model`` group against the
  whole module on the same inputs (outputs, input and parameter
  gradients), fp32 and bf16; and ``shard_state_dict`` then
  ``gather_state_dict`` of a tiny DiCoW;
- ``batches``: the fine-tune's loading path (``ModelTrainer._fit``) with the
  Trainer's loop replaced by a recorder of each batch this rank receives,
  beside the batches its own loader would have built;
- ``cli``: the port's CLI (``__main__.main``) with ARGS_JSON's argv, the
  eval batches each rank collates and the scoring calls counted;
- ``autobatch``: fine-tunes through ``ModelTrainer.train``, one after the
  other in this process, each with ARGS_JSON's overrides and optionally a
  fault raised in one rank's first memory probe (an out-of-memory error or
  a ValueError), before it or, with the fault's ``at: "encoder_layer1"``,
  from a forward pre-hook on encoder layer 1 inside the probe's forward
  (after layer 0's collectives); the micro-batch of every probe, the final
  micro-batch and accumulation, and the final state dict
  (``<tag><RANK>.pt``);
- ``probe_alone``: every rank builds the Trainer on ARGS_JSON's mesh, then
  rank 0 alone runs ``Trainer.probe_step`` on its first micro-batch while
  the others wait at a barrier, which rank 0 joins after it;
- ``probe_comms``: a Trainer probes its first micro-batch, then trains on
  it; a second Trainer on the same weights trains on it unprobed. The
  ``allocate`` calls of the FSDP2 comms (kind, size, dtype, class) in the
  probe
  and in the real step, the comm classes after the probe, and both
  steps' loss parts and final whole states (``state<RANK>_<probed|
  plain>.pt``).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    mode, outdir, init_file, rank, world = sys.argv[1:6]
    rank, world = int(rank), int(world)
    args = json.loads(sys.argv[6]) if len(sys.argv) > 6 else {}
    sys.modules["jax"] = None
    sys.modules["ts_asr_whisper_tpu"] = None
    import torch

    torch.set_num_threads(1)
    from ts_asr_whisper_tpu_torch.parallel import dist

    if world > 1:
        dist.initialize(backend="gloo", init_method=f"file://{init_file}",
                        world_size=world, rank=rank)
    assert dist.world_size() == world and dist.get_rank() == rank
    result = {"rank": rank, "world": dist.world_size(),
              **MODES[mode](outdir, rank, args)}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.finalize()


def run_primitives(outdir, rank, args):
    from ts_asr_whisper_tpu_torch.parallel import dist

    dist.barrier("start")
    payload = ({"metric": 41.5, "name": "tcp_wer",
                "sessions": ["a", "b"], "nested": {"x": 2}}
               if rank == 0 else None)
    got = dist.broadcast_from_main(payload)
    gathered = dist.gather_from_processes({"rank": rank, "tag": f"p{rank}"})
    big = dist.gather_from_processes("x" * ((rank + 1) * 100_000))
    big_ok = [len(s) == (r + 1) * 100_000 and set(s) == {"x"}
              for r, s in enumerate(big)]
    shard = dist.shard_indices_by_process(10)
    dist.barrier("end")
    return {"broadcast": got, "gathered": gathered, "shard": shard,
            "big_ok": big_ok}


def load_batches(path, rank, world):
    """Data coordinate ``rank``'s rows (of ``world``) of every global batch
    saved by the parent (``<step>/<key>`` arrays of an npz)."""
    import numpy as np

    data = np.load(path)
    steps = sorted({int(k.split("/")[0]) for k in data.files})
    out = []
    for i in range(steps[-1] + 1):
        keys = [k for k in data.files if k.startswith(f"{i}/")]
        rows = data[keys[0]].shape[0] // world
        out.append({k.split("/", 1)[1]: data[k][rank * rows:(rank + 1) * rows]
                    for k in keys})
    return out


def mesh_batches(path, mesh):
    """The batches of this rank's data coordinate, loaded by its model
    coordinate 0 and handed to the model peers (train.py's way)."""
    from ts_asr_whisper_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                        MODEL_AXIS,
                                                        axis_group,
                                                        axis_rank, axis_size)
    from ts_asr_whisper_tpu_torch.parallel.tensor import model_peer_batches

    build = axis_rank(mesh, MODEL_AXIS) == 0
    own = load_batches(path, axis_rank(mesh, DATA_AXIS),
                       axis_size(mesh, DATA_AXIS)) if build else ()
    return model_peer_batches(own, axis_group(mesh, MODEL_AXIS), build)


def build_model(args):
    import torch

    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.models.dicow import DiCoW
    from ts_asr_whisper_tpu_torch.training.lora import init_lora

    model = DiCoW(DiCoWConfig(**args["model"]), flash=True)
    if args.get("lora"):
        init_lora(model, torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(args["weights"]), strict=True)
    return model


def run_train(outdir, rank, args):
    """Also called in the test process itself (WORLD 1, no process
    group)."""
    import torch

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.parallel.mesh import (full_state_dict,
                                                        wrap_model)
    from ts_asr_whisper_tpu_torch.parallel.tensor import shard_model_
    from ts_asr_whisper_tpu_torch.training.checkpoints import (
        restore_checkpoint, save_model_checkpoint)
    from ts_asr_whisper_tpu_torch.training.trainer import Trainer

    world = dist.world_size()
    cfg = load_config(list(args["overrides"]), n_devices=world)
    model = build_model(args)
    trainer = Trainer(cfg, model, num_prefix_tokens=2)
    logged = []
    stream = trainer.metrics_logger

    class Recorder:
        def log(self, metrics, step):
            logged.append({"step": step,
                           **{k: float(v) for k, v in metrics.items()}})
            stream.log(metrics, step)

        def close(self):
            stream.close()

    trainer.metrics_logger = Recorder()
    state = trainer.train(mesh_batches(args["batches"], trainer.mesh))
    torch.save(full_state_dict(trainer.model, to_cpu=False),
               os.path.join(outdir, f"state{rank}.pt"))
    out = {"logged": logged, "phase": state.phase, "step": state.step,
           "updates": getattr(trainer.tx, "inner", trainer.tx).count}
    if args.get("ckpt"):
        save_model_checkpoint(args["ckpt"], trainer.model, step=state.step)
        restored, step = restore_checkpoint(args["ckpt"])
        fresh = build_model(args)
        fresh.load_state_dict(restored["params"])  # before the wrapper
        shard_model_(fresh, trainer.tp_group)
        fresh = wrap_model(fresh, trainer.mesh, cfg.training.shard_params)
        torch.save(full_state_dict(fresh, to_cpu=False),
                   os.path.join(outdir, f"restored{rank}.pt"))
        out["ckpt_step"] = step
    return out


def run_resume(outdir, rank, args):
    """A fresh model resumes ARGS_JSON's checkpoint on this run's mesh, as
    train.py does: the whole parameters loaded before the Trainer slices
    and wraps the model."""
    import torch

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.parallel.mesh import full_state_dict
    from ts_asr_whisper_tpu_torch.training.checkpoints import \
        restore_checkpoint
    from ts_asr_whisper_tpu_torch.training.trainer import Trainer

    cfg = load_config(list(args["overrides"]), n_devices=dist.world_size())
    restored, step = restore_checkpoint(args["ckpt"])
    model = build_model(args)
    model.load_state_dict(restored["params"])
    trainer = Trainer(cfg, model, num_prefix_tokens=2, start_step=step)
    torch.save(full_state_dict(trainer.model, to_cpu=False),
               os.path.join(outdir, f"resumed{rank}.pt"))
    heads = trainer.model.encoder.layers[0].self_attn.num_heads
    return {"step": trainer.state.step, "phase": trainer.state.phase,
            "local_heads": heads}


def run_tp_modules(outdir, rank, args):
    """Each module sliced over the world (one ``model`` group) against the
    whole module on the same inputs and upstream gradient: the largest
    relative differences of the output, the input gradients and each
    parameter's gradient (the whole one's slice of this rank)."""
    import torch

    from ts_asr_whisper_tpu_torch.models.config import DiCoWConfig
    from ts_asr_whisper_tpu_torch.models.dicow import SCB, DiCoW, init_dicow_
    from ts_asr_whisper_tpu_torch.models.whisper import (Attention,
                                                         DecoderLayer,
                                                         EncoderLayer)
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.parallel.tensor import (gather_state_dict,
                                                          shard_model_,
                                                          shard_state_dict,
                                                          tp_dim)

    group = torch.distributed.group.WORLD
    world = dist.world_size()
    d, heads, ffn, t = args["d"], args["heads"], args["ffn"], args["t"]

    def rel(a, b):
        # the smallest rtol at which |a - b| <= rtol (max|b| + |b|): an
        # allclose whose atol is rtol times the tensor's largest magnitude
        scale = b.abs().max().clamp_min(1e-30) + b.abs()
        return float(((a - b).abs() / scale).max())

    def build(kind):
        gen = torch.Generator().manual_seed(1)
        mod = {"attention": lambda: Attention(d, heads),
               "encoder_layer": lambda: EncoderLayer(d, heads, ffn),
               "decoder_layer": lambda: DecoderLayer(d, heads, ffn),
               "scb": lambda: SCB(d, heads, ffn)}[kind]()
        with torch.no_grad():
            for p in mod.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        return mod

    def inputs(kind):
        gen = torch.Generator().manual_seed(2)
        shape = (2, 2, t, d) if kind == "scb" else (2, t, d)
        xs = [torch.randn(shape, generator=gen)]
        if kind in ("attention", "decoder_layer"):
            xs.append(torch.randn(2, t + 3, d, generator=gen))
        return xs

    def call(kind, mod, xs, dtype):
        if kind == "attention":
            return mod(xs[0], xs[1], dtype)
        if kind == "encoder_layer":
            return mod(xs[0], dtype)
        if kind == "decoder_layer":
            mask = torch.ones(t, t, dtype=torch.bool).tril()
            return mod(xs[0], xs[1], dtype, mask)
        return mod(xs[0], dtype)

    out = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        for kind in ("attention", "encoder_layer", "decoder_layer", "scb"):
            runs = []
            for sliced in (False, True):
                mod = build(kind)
                if sliced:
                    shard_model_(mod, group)
                xs = [x.clone().requires_grad_() for x in inputs(kind)]
                y = call(kind, mod, xs, dtype)
                g = torch.randn(y.shape, generator=torch.Generator()
                                .manual_seed(3)).to(y.dtype)
                y.backward(g)
                runs.append((y.detach().float(), [x.grad for x in xs],
                             {n: p.grad for n, p in mod.named_parameters()}))
            (y0, dx0, dp0), (y1, dx1, dp1) = runs
            key = f"{kind}/{str(dtype)[6:]}"
            params = {}
            for name, g in dp0.items():
                dim = tp_dim(name)
                if dim is not None:
                    n = g.shape[dim] // world
                    g = g.narrow(dim, rank * n, n)
                params[name] = rel(dp1[name].float(), g.float())
            out[key] = {"out": rel(y1, y0),
                        "dx": max(rel(a.float(), b.float())
                                  for a, b in zip(dx1, dx0)),
                        "params": params, "sliced": sorted(
                            n for n in dp0 if tp_dim(n) is not None)}
    cfg = DiCoWConfig(**args["model"])
    full = init_dicow_(DiCoW(cfg), torch.Generator().manual_seed(4)) \
        .state_dict()
    local = shard_state_dict(full, rank, world)
    back = gather_state_dict(local, group)
    out["round_trip"] = sorted(back) == sorted(full) and all(
        torch.equal(back[k], v) for k, v in full.items())
    out["local_shapes"] = {k: list(v.shape) for k, v in local.items()
                           if tp_dim(k) is not None}
    return out


def run_batches(outdir, rank, args):
    """The fine-tune's loading path through ``ModelTrainer._fit`` with the
    Trainer's loop replaced: each batch this rank receives, as a digest of
    its arrays, and the batches its own loader builds for the same data
    coordinate, for comparison (the collator's augmentations draw from
    unseeded global generators)."""
    import hashlib

    import numpy as np

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.parallel.mesh import DATA_AXIS, axis_rank
    from ts_asr_whisper_tpu_torch.train import ModelTrainer
    from ts_asr_whisper_tpu_torch.training import trainer as trainer_mod
    from ts_asr_whisper_tpu_torch.training.dataloader import DataLoader

    def digest(batch):
        h = hashlib.sha256()
        for k in sorted(batch):
            h.update(k.encode() + np.ascontiguousarray(batch[k]).tobytes())
        return h.hexdigest()

    cfg = load_config(list(args["overrides"]), n_devices=dist.world_size())
    mt = ModelTrainer(cfg, "cpu")
    got = {}

    def record(self, it):
        got["data_rank"] = axis_rank(self.mesh, DATA_AXIS)
        got["received"] = [digest(b) for _, b in zip(range(args["n"]), it)]
        got["rows"] = cfg.training.per_device_train_batch_size
        return trainer_mod.TrainState(0, self.state.phase)

    trainer_mod.Trainer.train = record
    mt._fit(2, 0, None, None, None, None)
    t = cfg.training
    own = DataLoader(mt.train_dataset, mt.collator,
                     batch_size=t.per_device_train_batch_size
                     * dist.world_size(), seed=t.seed, num_workers=1,
                     process_index=got["data_rank"],
                     process_count=args["data"])
    got["own"] = [digest(b) for _, b in zip(range(args["n"]), own)]
    first = next(iter(own))
    got["local_rows"] = int(first["input_features"].shape[0])
    return got


def run_cli(outdir, rank, args):
    from ts_asr_whisper_tpu_torch import __main__ as cli
    from ts_asr_whisper_tpu_torch import decode

    decoded, scored = [], []
    real_batches, real_metrics = decode.eval_batches, \
        decode.compute_longform_metrics

    def counting_batches(*a, **kw):
        for bi, batch in real_batches(*a, **kw):
            decoded.append(bi)
            yield bi, batch

    def counting_metrics(*a, **kw):
        scored.append(len(a[0]))
        return real_metrics(*a, **kw)

    decode.eval_batches = counting_batches
    decode.compute_longform_metrics = counting_metrics
    metrics = cli.main(list(args["argv"]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "decoded_batches": decoded, "scored": scored}


def run_autobatch(outdir, rank, args):
    import torch

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.train import ModelTrainer
    from ts_asr_whisper_tpu_torch.training.trainer import Trainer

    faults = {"oom": lambda: torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
        "value": lambda: ValueError("bad batch")}
    probe = Trainer.probe_step
    out = {}
    for run in args["runs"]:
        probed = []

        def probe_step(self, batch):
            probed.append(self.cfg.training.per_device_train_batch_size)
            fault = run.get("fault")
            if not (fault and fault["rank"] == rank and len(probed) == 1):
                return probe(self, batch)
            if fault.get("at") != "encoder_layer1":
                raise faults[fault["error"]]()

            def fail(module, inputs):
                raise faults[fault["error"]]()

            hook = self.model.encoder.layers[1].register_forward_pre_hook(
                fail)
            try:
                return probe(self, batch)
            finally:
                hook.remove()

        Trainer.probe_step = probe_step
        try:
            cfg = load_config(list(run["overrides"]),
                              n_devices=dist.world_size())
            mt = ModelTrainer(cfg, "cpu")
            mt.train()
        finally:
            Trainer.probe_step = probe
        t = cfg.training
        torch.save(mt.model.state_dict(),
                   os.path.join(outdir, f"{run['tag']}{rank}.pt"))
        out[run["tag"]] = {"probed": probed,
                           "batch": t.per_device_train_batch_size,
                           "accum": t.gradient_accumulation_steps}
    return out


def _first_probe_batch(cfg):
    """A ModelTrainer on ``cfg`` and the first micro-batch of this rank's
    data coordinate (each rank loads its own: the augmentations are off)
    with the labels the probe gives it, as tensors."""
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.parallel.mesh import (DATA_AXIS, axis_rank,
                                                        axis_size, make_mesh)
    from ts_asr_whisper_tpu_torch.train import ModelTrainer, probe_batch
    from ts_asr_whisper_tpu_torch.training.dataloader import DataLoader
    from ts_asr_whisper_tpu_torch.training.trainer import to_device

    t = cfg.training
    mt = ModelTrainer(cfg, "cpu")
    mesh = make_mesh(t.mesh_shape, t.mesh_axis_names, "cpu")
    loader = DataLoader(mt.train_dataset, mt.collator,
                        batch_size=t.per_device_train_batch_size
                        * dist.world_size(), seed=t.seed, num_workers=1,
                        process_index=axis_rank(mesh, DATA_AXIS),
                        process_count=axis_size(mesh, DATA_AXIS))
    first = next(iter(loader))
    probe = to_device(probe_batch(first, mt.probe_width()), "cpu")
    return mt, to_device(first, "cpu"), probe


def run_probe_alone(outdir, rank, args):
    import time

    import torch.distributed as tdist

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.training.trainer import Trainer

    cfg = load_config(list(args["overrides"]), n_devices=dist.world_size())
    mt, _, probe = _first_probe_batch(cfg)
    trainer = Trainer(cfg, mt.model, num_prefix_tokens=2)
    t0 = time.perf_counter()
    if rank == 0:
        trainer.probe_step(probe)
    probed = time.perf_counter() - t0
    tdist.barrier()
    return {"probed_alone": rank == 0, "probe_s": probed,
            "grads_left": sum(p.grad is not None
                              for p in trainer.model.parameters())}


def run_probe_comms(outdir, rank, args):
    import torch
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.fsdp._fully_shard import _fsdp_collectives as C

    from ts_asr_whisper_tpu_torch.config import load_config
    from ts_asr_whisper_tpu_torch.models.containers import WhisperContainer
    from ts_asr_whisper_tpu_torch.parallel import dist
    from ts_asr_whisper_tpu_torch.parallel import mesh as M
    from ts_asr_whisper_tpu_torch.parallel import tensor as T
    from ts_asr_whisper_tpu_torch.parallel.mesh import full_state_dict
    from ts_asr_whisper_tpu_torch.training.trainer import Trainer

    calls = []

    def recorded(cls, kind):
        allocate = cls.allocate

        def wrapper(self, size, *, dtype, device):
            calls.append([kind, [int(n) for n in size], str(dtype),
                          cls.__name__])
            return allocate(self, size, dtype=dtype, device=device)
        cls.allocate = wrapper

    for cls, kind in ((C.DefaultAllGather, "all_gather"),
                      (M._LocalAllGather, "all_gather"),
                      (C.DefaultReduceScatter, "reduce_scatter"),
                      (M._LocalReduceScatter, "reduce_scatter")):
        recorded(cls, kind)
    cfg = load_config(list(args["overrides"]), n_devices=dist.world_size())
    mt, batch, probe = _first_probe_batch(cfg)
    out = {}
    trainer = Trainer(cfg, mt.model, num_prefix_tokens=2)
    trainer.probe_step(probe)
    out["probe_allocs"], calls[:] = list(calls), []
    out["comms_after_probe"] = sorted({
        type(c).__name__ for m in trainer.model.modules()
        if isinstance(m, FSDPModule) for g in M._fsdp_param_groups(m)
        for c in (g._all_gather_comm, g._reduce_scatter_comm)})
    out["local_only_after_probe"] = T.local_only["on"]
    models = {"probed": trainer.model,
              "plain": WhisperContainer(cfg, "cpu",
                                        seed=cfg.training.seed).model}
    for tag, model in models.items():
        if tag == "plain":
            trainer = Trainer(cfg, model, num_prefix_tokens=2)
        parts = trainer.train_step(batch)
        parts = trainer._global_parts(parts)
        out[f"{tag}_parts"] = {k: float(v) for k, v in parts.items()}
        out[f"{tag}_allocs"], calls[:] = list(calls), []
        torch.save(full_state_dict(trainer.model, to_cpu=False),
                   os.path.join(outdir, f"state{rank}_{tag}.pt"))
    return out


MODES = {"primitives": run_primitives, "train": run_train, "cli": run_cli,
         "resume": run_resume, "tp_modules": run_tp_modules,
         "batches": run_batches, "autobatch": run_autobatch,
         "probe_alone": run_probe_alone, "probe_comms": run_probe_comms}


def spawn(mode, outdir, world, args, timeout=120, check=True):
    """Run WORLD workers of MODE (in the test process); every worker and
    its children are killed at the timeout (which raises
    ``subprocess.TimeoutExpired``). Returns the ranks' results, or with
    ``check=False`` each rank's (return code, output)."""
    import signal
    import subprocess
    import time
    from pathlib import Path

    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    init = outdir / "pg_init"
    if init.exists():
        init.unlink()
    repo = Path(__file__).resolve().parents[1]
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(repo),
           "HOME": str(outdir), "OMP_NUM_THREADS": "1",
           "TMPDIR": os.environ.get("TMPDIR", str(outdir))}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), mode, str(outdir),
         str(init), str(rank), str(world), json.dumps(args)],
        cwd=str(repo), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if not check:
        return [(p.returncode, out.decode()) for p, out in zip(procs, outs)]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {rank} failed (rc={p.returncode}):\n"
            f"{out.decode()[-4000:]}")
    results = []
    for rank in range(world):
        with open(outdir / f"rank{rank}.json") as f:
            results.append(json.load(f))
    return results


if __name__ == "__main__":
    main()
