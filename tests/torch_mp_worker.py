"""Multi-process worker of the port's data-parallel tests
(tests/test_torch_dist.py, test_torch_ddp.py, test_torch_fsdp.py), after
tests/mp_worker.py. Not collected by pytest; run as

    python tests/torch_mp_worker.py MODE OUTDIR INIT_FILE RANK WORLD ARGS_JSON

Each worker blocks jax and the JAX package (the port needs neither), caps
torch at one thread, joins a gloo process group through the shared file
INIT_FILE (``file://``, so no port is needed) unless WORLD is 1, runs MODE
and writes ``rank<RANK>.json`` into OUTDIR. Modes:

- ``primitives``: barrier, broadcast_from_main of a nested object,
  gather_from_processes (small and uneven ~100k / 200k character
  payloads), shard_indices_by_process;
- ``train``: the port's Trainer on the tiny DiCoW of ARGS_JSON's weights
  over this rank's rows of each global batch (DDP, or FSDP2 under
  ``training.shard_params``); the logged metrics and the final whole state
  dict (``state<RANK>.pt``); optionally a checkpoint saved and restored
  into a fresh sharded model (``restored<RANK>.pt``);
- ``cli``: the port's CLI (``__main__.main``) with ARGS_JSON's argv, the
  eval batches each rank collates and the scoring calls counted.
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
    """This rank's rows of every global batch saved by the parent
    (``<step>/<key>`` arrays of an npz)."""
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
    state = trainer.train(iter(load_batches(args["batches"], rank, world)))
    torch.save(full_state_dict(trainer.model, to_cpu=False),
               os.path.join(outdir, f"state{rank}.pt"))
    out = {"logged": logged, "phase": state.phase, "step": state.step,
           "updates": getattr(trainer.tx, "inner", trainer.tx).count}
    if args.get("ckpt"):
        save_model_checkpoint(args["ckpt"], trainer.model, step=state.step)
        restored, step = restore_checkpoint(args["ckpt"])
        fresh = build_model(args)
        fresh.load_state_dict(restored["params"])  # before the wrapper
        fresh = wrap_model(fresh, trainer.mesh, cfg.training.shard_params)
        torch.save(full_state_dict(fresh, to_cpu=False),
                   os.path.join(outdir, f"restored{rank}.pt"))
        out["ckpt_step"] = step
    return out


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


MODES = {"primitives": run_primitives, "train": run_train, "cli": run_cli}


def spawn(mode, outdir, world, args, timeout=120):
    """Run WORLD workers of MODE (in the test process); every worker and
    its children are killed at the timeout. Returns the ranks' results."""
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
