"""A run of a tiny cell on the CPU, as the benchmark runs it but past the
look for a chip, with the timed path optionally broken underneath:

    python -m benchmark.tests.dry_run <tmp dir> <cell> [fault]

or, on the card, the program's numbers of a cell at its own size with a
fault planted, on each seed (the readings a limit is held against):

    python -m benchmark.tests.dry_run --full <cell> <fault> <seed>...

Faults: ``stale_state`` (decode: the self-attention cache never written;
train: the optimizer's step leaves the parameters as they were),
``half_batch`` (decode: the encoder runs the first half of the bucket and
its outputs stand in for the rest; train: the loss is the mean over the
first half of the rows), ``altered_token`` (decode: at every step the decode loop
chooses the runner-up token and feeds it back in)."""

import sys
import time
from pathlib import Path

T0 = time.perf_counter()


def plant(fault: str, kind: str) -> None:
    """Break the timed path of a ``kind`` ('decode' or 'train') cell."""
    import torch

    from ts_asr_whisper_tpu_torch.decoding import greedy
    from ts_asr_whisper_tpu_torch.models import dicow, whisper
    from ts_asr_whisper_tpu_torch.training import optim, trainer

    if (fault, kind) == ("stale_state", "decode"):
        orig = whisper.WhisperDecoder.decoder_cached

        def stale(self, ids, pos, cache, cross, *a, **k):
            return orig(self, ids, pos, {n: t.clone() for n, t in
                                         cache.items()}, cross, *a, **k)
        whisper.WhisperDecoder.decoder_cached = stale
    elif (fault, kind) == ("stale_state", "train"):
        optim.AdamW.step = lambda self, grads: None
    elif (fault, kind) == ("half_batch", "decode"):
        enc_fwd = dicow.DiCoWEncoder.forward

        def half(self, x, stno=None, *a, **k):
            b = x.shape[0]
            h = max(1, b // 2)
            out = enc_fwd(self, x[:h], stno[:h], *a, **k)
            return torch.cat([out] * (-(-b // h)))[:b]
        dicow.DiCoWEncoder.forward = half
    elif (fault, kind) == ("half_batch", "train"):
        loss_fn = trainer.loss_fn

        def half_loss(model, cfg, batch, *a, **k):
            h = max(1, batch["labels"].shape[0] // 2)
            return loss_fn(model, cfg, {n: t[:h] for n, t in batch.items()},
                           *a, **k)
        trainer.loss_fn = half_loss
    elif (fault, kind) == ("altered_token", "decode"):
        make = greedy.make_logits_processor

        def runner_up(*a, **k):
            # each step's best open token closed where the loop chooses:
            # it takes the runner-up and feeds it back in, so its logits
            # follow the wrong token
            process = make(*a, **k)

            def wrong(scores, *b, **c):
                s = process(scores, *b, **c)
                shut = torch.finfo(s.dtype).min
                closed = s.scatter(1, s.argmax(-1, keepdim=True), shut)
                # a row with one open token keeps it
                return torch.where(closed.amax(-1, keepdim=True) > shut,
                                   closed, s)
            return wrong
        greedy.make_logits_processor = runner_up
    elif fault:
        raise ValueError(fault)


def full(cell: str, fault: str, seeds) -> int:
    root_dir = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root_dir))
    import torch

    from benchmark import harness, run

    run.cache_env(root_dir)
    spec = harness.Spec(root_dir)
    kind = spec.cell(cell)["driver"]
    plant(fault, kind)
    driver = spec.driver(kind)
    driver.calibrate(spec, cell, [int(x) for x in seeds], 1.0,
                     torch.device("cuda", 0), run.log, control=False)
    return 0


def main() -> int:
    if sys.argv[1] == "--full":
        return full(sys.argv[2], sys.argv[3], sys.argv[4:])
    tmp, cell = Path(sys.argv[1]), sys.argv[2]
    fault = sys.argv[3] if len(sys.argv) > 3 else ""
    root_dir = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root_dir))
    from benchmark import run
    from benchmark.tests.tiny import make_tiny

    root, bench = make_tiny(tmp)
    from benchmark import harness

    plant(fault, harness.Spec(root, bench).cell(cell)["driver"])
    return run.main(["--workload", cell, "--seed", "2147483659",
                     "--seconds", "1", "--trace", "0"],
                    root=root, bench=bench, require_cuda=False, t_start=T0)


if __name__ == "__main__":
    sys.exit(main())
