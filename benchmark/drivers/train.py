"""Fine-tune cells: the port's ``Trainer.train`` fed by its ``DataLoader``
over a synthetic corpus of 30 s cuts, timed over whole optimizer updates
for ``--seconds``.

Set-up writes the corpus and a model directory, builds the port's
``ModelTrainer`` (datasets, collator with the published STNO and SpecAug
augmentations) from its config groups, loads the benchmark's weights
(``reference/dicow.py::make_weights``), builds the ``Trainer`` and the
loader as ``ModelTrainer._fit`` does, and starts ``Trainer.train`` over
the loader's batches. Its first ``check_updates`` updates end the set-up:
they warm up every kernel, and they are what the reference follows. The
window is the same call going on from that update boundary; the feed ends
it at the first boundary after ``--seconds``, and the card is synchronised
at its two ends only, as the port's own loop runs.

The comparison that decides ``correct``: the reference (float32, plain
PyTorch) takes the micro-batches of the set-up's updates and of the
window's first update as the port's collator gave them (its augmentations
draw from a shared random state, so they cannot be drawn again), follows
the set-up's updates from the benchmark's weights, and reads the loss
parts of the window's first update at the parameters they left: the first
update's loss, the decoder cross-entropy and the CTC loss of every
micro-batch followed, the first gradient as the optimizer got it (from its
first moment after one update) leaf by leaf, and each trained leaf's
change after the set-up's updates. The stage this skips, the features and
STNO of the rows, is compared apart: the port's dataset items of the first
rows against the reference's own log-mel and STNO.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from benchmark import roofline
from benchmark.devicetime import DeviceTrace
from benchmark.reference import dicow as ref
from benchmark.reference.train import ReferenceTrainer, worst_leaf
from benchmark.spans import Recorder
from benchmark.traffic import synthetic
from benchmark.drivers.decode import HF_KEYS, _dtype_name

GIB = 2 ** 30
BATCH_KEYS = ("input_features", "stno_mask", "labels", "upp_labels",
              "enroll_features", "enroll_stno")


def plan_cuts(mix: dict, seed: int) -> List[synthetic.Recording]:
    """``mix['cuts']`` recordings of ``mix['seconds']``: 2-4 speakers in
    the mix's proportions, turns drawn as for the decode corpora, words
    per second drawn for each speaker."""
    rng = np.random.default_rng([seed, synthetic.zlib_tag("train")])
    recs = []
    counts = [k for k, n in mix["speakers"].items() for _ in range(n)]
    for i in range(mix["cuts"]):
        k = int(counts[i % len(counts)])
        spk = [f"t{i}spk{j}" for j in range(k)]
        rec = synthetic.Recording(id=f"t{i}", duration=mix["seconds"],
                                  speakers=spk)
        rec.turns = synthetic.draw_turns(rng, mix["seconds"], spk,
                                         mix["turn_seconds"],
                                         float(rng.uniform(*mix["overlap"])))
        rate = {s: float(rng.uniform(*mix["words_per_second"])) for s in spk}
        words = [list(rng.choice(synthetic.WORDS,
                                 size=max(1, int(d * rate[s]))))
                 for s, a, d, _ in rec.turns]
        # each speaker's label at most max_label_chars bytes (one token a
        # byte, two timestamps a turn): the label width, and with it the
        # step's shapes and peak memory, the same in every window
        for s in spk:
            mine = [w for w, t in zip(words, rec.turns) if t[0] == s]
            while (sum(len(" ".join(w)) + 2 for w in mine)
                   > mix["max_label_chars"]):
                max(mine, key=len).pop()
        rec.turns = [(s, a, d, " ".join(w)) for (s, a, d, _), w in
                     zip(rec.turns, words)]
        recs.append(rec)
    order = rng.permutation(len(recs))
    return [recs[int(i)] for i in order]


def plan_enrollment(recs: List[synthetic.Recording], mix: dict,
                    seed: int) -> List[synthetic.Recording]:
    """SE-DiCoW's enrollment corpus: for every speaker of the training
    cuts, ``cuts_per_speaker`` single-speaker recordings of drawn length,
    the speaker talking through each."""
    rng = np.random.default_rng([seed, synthetic.zlib_tag("enroll")])
    out = []
    for r in recs:
        for spk in r.speakers:
            for k in range(mix["cuts_per_speaker"]):
                dur = round(float(rng.uniform(*mix["seconds"])), 2)
                e = synthetic.Recording(id=f"e_{spk}_{k}", duration=dur,
                                        speakers=[spk])
                words = " ".join(rng.choice(synthetic.WORDS,
                                            size=max(1, int(dur * 2))))
                e.turns = [(spk, 0.3, round(dur - 0.6, 2), words)]
                out.append(e)
    return out


class TrainCell:
    def __init__(self, spec, name: str, seed: int, device: torch.device,
                 workdir: Path):
        self.spec, self.name, self.seed = spec, name, int(seed)
        self.cell = spec.cell(name)
        self.cfg = spec.config(self.cell["config"])
        self.mix = spec.traffic(self.cell["traffic"])
        self.device = torch.device(device)
        self.workdir = Path(workdir)
        self.captured: List[dict] = []

    def write_inputs(self) -> None:
        self.recs = plan_cuts(self.mix, self.seed)
        data = self.workdir / "data"
        self.manifest = synthetic.write_corpus(data, self.recs, self.seed,
                                               "train_cutset_30s")
        self.enroll_manifest = None
        if "enrollment" in self.mix:
            self.enroll_manifest = synthetic.write_corpus(
                data, plan_enrollment(self.recs, self.mix["enrollment"],
                                      self.seed), self.seed, "enroll_cutset")
        model_dir = self.workdir / "model"
        model_dir.mkdir(parents=True, exist_ok=True)
        with open(model_dir / "config.json", "w") as f:
            json.dump({k: self.cfg[k] for k in HF_KEYS}, f)
        self.model_dir = model_dir

    def overrides(self) -> List[str]:
        c, t = self.cell, self.cell["train"]
        data = [f"data.train_cutsets=[{self.manifest}]"]
        if self.enroll_manifest is not None:
            # each row's enrollment a mixture drawn from the enrollment
            # corpus (the port's '_external_enrollment' convention)
            ext = str(self.manifest).replace(".jsonl.gz",
                                             "_external_enrollment.jsonl.gz")
            data = [f"data.train_cutsets=[{ext}]",
                    f"data.enrollment_cutsets=[{self.enroll_manifest}]"]
        return list(c["port_overrides"]) + list(self.cfg["port_overrides"]) + [
            f"model.whisper_model={self.model_dir}", *data,
            "data.dev_cutsets=[]", "data.eval_cutsets=[]",
            "training.overall_batch_size=0",
            f"training.per_device_train_batch_size={c['micro_batch']}",
            f"training.gradient_accumulation_steps={c['accumulation']}",
            f"training.warmup_steps={t['warmup_steps']}",
            f"training.max_steps={t['max_steps']}",
            f"training.seed={self.seed % 2 ** 31}",
            f"training.output_dir={self.workdir / 'out'}",
            "training.mesh_shape=[1]"]

    def build(self) -> None:
        from ts_asr_whisper_tpu_torch import train as train_mod
        from ts_asr_whisper_tpu_torch.config import load_config
        from ts_asr_whisper_tpu_torch.decode import no_tf32
        from ts_asr_whisper_tpu_torch.training.dataloader import DataLoader
        from ts_asr_whisper_tpu_torch.training.trainer import (Trainer,
                                                               to_device)

        cfg = load_config(self.overrides())
        no_tf32()
        np.random.seed(self.seed % 2 ** 32)
        self.mt = train_mod.ModelTrainer(cfg, self.device)
        w = ref.make_weights(self.cfg, self.seed, self.device)
        self.mt.model.load_state_dict(w, strict=True)
        del w
        t = cfg.training
        self.num_prefix = len(self.mt.container.tokenizer.prefix_tokens) - 1
        bs = t.per_device_train_batch_size
        self.trainer = Trainer(cfg, self.mt.model,
                               num_prefix_tokens=self.num_prefix,
                               steps_per_epoch=len(self.mt.train_dataset)
                               // bs or None)
        self.loader = DataLoader(
            self.mt.train_dataset, self.mt.collator, batch_size=bs,
            seed=t.seed, num_workers=t.dataloader_num_workers,
            prefetch_factor=t.dataloader_prefetch_factor,
            worker_type=t.dataloader_worker_type, num_epochs=None)
        self.batches = iter(self.loader)
        self.to_device = to_device
        self.t = t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def feed(self, rec: Recorder, stop):
        """The loader's micro-batches for ``Trainer.train``. Before each
        update's first micro-batch ``stop(n)``, with ``n`` updates done,
        says whether the run ends there: it ends at an update boundary."""
        n = 0
        while not stop(n):
            for _ in range(self.cell["accumulation"]):
                with rec.span("data_wait"):
                    host = next(self.batches)
                labels = np.asarray(host["labels"])
                rec.counters["rows"] += int(labels.shape[0])
                rec.counters["label_tokens"] += int((labels != -100).sum())
                self.host = host
                yield host
            n += 1
            rec.counters["updates"] += 1

    def drive(self, seconds: float, trace: bool, t_start: float) -> dict:
        """One ``Trainer.train`` call over :meth:`feed`: the first
        ``check_updates`` updates end the set-up (the reference follows
        them; the first moment is read after the first, each trained
        leaf's change after the last), and the window continues the same
        loop from that update boundary for ``seconds`` (``--trace 1``:
        ``trace_updates`` updates under ``torch.profiler``), at least one
        update. The card is synchronised at the window's two ends only."""
        from ts_asr_whisper_tpu_torch import kernels
        from ts_asr_whisper_tpu_torch.ops import attention

        checks = self.cell["check_updates"]
        limit = self.cell["trace_updates"] if trace else None
        tx = self.trainer.tx
        inner = getattr(tx, "inner", tx)
        names = {id(p): n for n, p in self.mt.model.named_parameters()}
        rec = Recorder()
        rec.on = False
        bwd_bounds: List[float] = []
        tr = DeviceTrace() if trace else None
        st = {"t0": None, "traced": False, "launches0": None}

        def keep(args, kwargs, parts):
            # the micro-batches of the set-up's updates and of the window's
            # first, with their loss parts (0-d tensors, read after it)
            if st["t0"] is None or rec.counters["updates"] == 0:
                self.captured.append({
                    "batch": {k: np.array(self.host[k]) for k in BATCH_KEYS
                              if k in self.host},
                    "parts": {k: v for k, v in parts.items()
                              if k in ("loss", "dec_loss", "ctc_loss")},
                    "window": st["t0"] is not None})

        def on_bwd(args, kwargs, out):
            q = args[0]
            b, h, t, d = q.shape
            bwd_bounds.append(roofline.bound_s(
                *roofline.flash_bwd(b * h, t, d, q.element_size()),
                _dtype_name(q.dtype)))

        def stop(n: int) -> bool:
            if n == 1:
                b1 = self.t.adam_beta1
                self.grad_norms = {
                    names[id(p)]: float((m.float() / (1 - b1)).norm())
                    for p, m in zip(inner.params, inner.mu)}
            if n < checks:
                return False
            if n == checks:
                w0 = ref.make_weights(self.cfg, self.seed, self.device)
                self.change_norms = {
                    names[id(p)]: float((p.detach().float()
                                         - w0[names[id(p)]]).norm())
                    for p in inner.params}
                del w0
                self._sync()
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                rec.spans.clear()
                rec.counters.clear()
                rec.on = trace
                st["launches0"] = dict(kernels.launch_counts)
                if tr is not None:
                    tr.__enter__()
                    st["traced"] = True
                st["t0"] = time.perf_counter()
                self.setup_s = st["t0"] - t_start
                return False
            if limit is not None:
                return n - checks >= limit
            return time.perf_counter() - st["t0"] >= seconds

        rec.wrap(self.trainer, "train_step", "train_step", after=keep)
        rec.wrap(tx, "step", "optimizer")
        if trace:
            rec.wrap(attention, "flash_mha_bwd", "flash_bwd", after=on_bwd)
        try:
            self.trainer.train(self.feed(rec, stop))
            self._sync()
            wall = time.perf_counter() - st["t0"]
        finally:
            if st["traced"]:
                tr.__exit__(None, None, None)
            rec.restore()
            # the instance attribute the wrapper left shadows the method
            self.trainer.__dict__.pop("train_step", None)
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        launches0 = st["launches0"]
        work = {"updates": rec.counters["updates"],
                "rows": rec.counters["rows"],
                "label_tokens": rec.counters["label_tokens"],
                "launches": {k: v - launches0.get(k, 0)
                             for k, v in kernels.launch_counts.items()
                             if v - launches0.get(k, 0)}}
        out = {"wall_s": wall, "work": work, "memory_peak_bytes": int(peak),
               "train_update_ms": 1e3 * wall / work["updates"],
               "train_peak_mem_gib": peak / GIB}
        if trace:
            out["trace"] = tr.result()
            out["ctx"] = {"rec": rec, "trace": out["trace"], "work": work,
                          "flash_bwd_bounds": bwd_bounds,
                          "flops": self.window_flops(work), "wall_s": wall}
        return out

    def window_flops(self, work: dict) -> float:
        """Model FLOPs of the window's rows: forward and backward of the
        trained encoder and CTC head (three times the forward), the frozen
        decoder's forward and its activation gradients (twice) over each
        row's label tokens, and its cross-attention k/v."""
        c = self.cfg
        enc = (roofline.encoder_window_flops(c) + roofline.ctc_head_flops(c))
        per_tok = roofline.decoder_token_flops(c, 112)
        return (work["rows"] * (3 * enc + 2 * roofline.cross_kv_flops(c))
                + 2 * work["label_tokens"] * per_tok)

    def release_program(self) -> None:
        self.batches.close()
        self.batches = self.loader = self.trainer = self.mt = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def read_inputs(self, control: bool = False) -> None:
        """The stage the reference does not follow: the port's dataset
        items of the first rows (before augmentation) against the
        reference's own log-mel and STNO of the same cuts. With
        ``control``, the same of the reference's log-mel rounded to
        bfloat16."""
        ds = self.mt.train_dataset
        rows = synthetic.rows(self.recs)
        gaps, ctl = [], []
        for i in range(min(self.cell["check_rows"], len(rows))):
            item = ds[i]
            rec, spk = rows[i]
            samples = synthetic.read_wav(rec.path)
            mel, _ = ref.log_mel(samples, self.cfg["num_mel_bins"],
                                 self.device)
            mel = mel.cpu()
            st = ref.stno(rec.turns, spk, sorted(rec.speakers),
                          samples.shape[0])
            gaps.append(float((mel - torch.as_tensor(
                item["input_features"])).abs().max()))
            gaps.append(float(np.abs(st.T - item["stno_mask"]).max()))
            if control:
                ctl.append(float((mel.bfloat16().float() - mel).abs().max()))
        self.input_gap = max(gaps)
        self.input_control = max(ctl) if ctl else math.nan

    def check(self, control: bool = False) -> dict:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = self._follow(None)
            if control:
                low = self._follow(ref.fp8_matmul)
                out["control"] = self._numbers(low, out["ref"])
            return out
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    def _follow(self, mm) -> dict:
        """The reference through the set-up's updates, then the loss parts
        of the window's first update at the parameters they left."""
        t = self.cell["train"]
        rt = ReferenceTrainer(self.cfg, t, self.seed, self.device, mm,
                              remat=mm is not None)
        acc = self.cell["accumulation"]
        block = self.cell["ref_block"]
        setup = [c["batch"] for c in self.captured if not c["window"]]
        steps = [rt.update(setup[i: i + acc], block=block)
                 for i in range(0, len(setup), acc)]
        res = {"parts": [p for s in steps for p in s["parts"]],
               "grad_norms": steps[0]["grad_norms"],
               "raw_grad_norms": steps[0]["raw_grad_norms"],
               "change_norms": rt.change_norms()}
        res["parts"] += rt.losses([c["batch"] for c in self.captured
                                   if c["window"]], block=block)
        if mm is None:
            prog = {"parts": [{k: float(v) for k, v in c["parts"].items()}
                              for c in self.captured],
                    "grad_norms": self.grad_norms,
                    "change_norms": self.change_norms}
            res = {"ref": res, **self._numbers(prog, res)}
        del rt
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return res

    def _numbers(self, prog: dict, r: dict) -> dict:
        """The numbers compared: the widest relative gap of the first
        update's loss (later losses follow parameters that AdamW's first,
        sign-like steps set apart wherever a gradient is at rounding
        level); the widest relative gaps of the decoder cross-entropy and
        of the CTC loss over every micro-batch followed, the window's first
        update's among them; the worst leaf's gap of the first gradient's
        norm; the worst leaf's gap of the change's norm (leaves the
        reference's gradient leaves at round-off, under a thousandth of the
        median leaf's, left out)."""
        names = sorted(r["grad_norms"])
        med = float(np.median([r["raw_grad_norms"][n] for n in names]))
        moved = [n for n in names if r["raw_grad_norms"][n] >= 1e-3 * med]
        first = self.cell["accumulation"]

        def gap(key, parts):
            return max(abs(a[key] - b[key]) / abs(b[key])
                       for a, b in zip(prog["parts"][parts],
                                       r["parts"][parts]))

        grad_gap, grad_leaf = worst_leaf(prog["grad_norms"],
                                         r["grad_norms"], names)
        change_gap, change_leaf = worst_leaf(prog["change_norms"],
                                             r["change_norms"], moved)
        every = slice(None)
        return {"loss_gap": gap("loss", slice(first)),
                "ce_gap": gap("dec_loss", every),
                "ctc_gap": gap("ctc_loss", every),
                "grad_gap": grad_gap, "grad_leaf": grad_leaf,
                "change_gap": change_gap, "change_leaf": change_leaf,
                "left_out": sorted(set(names) - set(moved)),
                "prog_losses": [p["loss"] for p in prog["parts"]],
                "ref_losses": [p["loss"] for p in r["parts"]]}


CHECKS = ("loss_gap", "ce_gap", "ctc_gap", "grad_gap", "change_gap")


def _setup(cell: "TrainCell", seconds: float, trace: bool, t_start: float,
           log) -> dict:
    """Set-up and the window: the corpus, the trainer, then one
    ``Trainer.train`` call whose first updates end the set-up."""
    marks = [("start", time.perf_counter() - t_start)]
    for step in (cell.write_inputs, cell.build):
        step()
        marks.append((step.__name__, time.perf_counter() - t_start))
    res = cell.drive(seconds, trace, t_start)
    marks.append(("first_updates", cell.setup_s))
    log("set-up: " + " ".join(f"{n} {t:.3f}" for n, t in marks))
    res["setup_s"] = cell.setup_s
    return res


def run(spec, name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log) -> dict:
    workdir = Path(tempfile.mkdtemp(prefix="bench_train_"))
    try:
        cell = TrainCell(spec, name, seed, device, workdir)
        res = _setup(cell, seconds, trace, t_start, log)
        setup_s = res["setup_s"]
        w = res["work"]
        log(f"work: updates {w['updates']} rows {w['rows']} label_tokens "
            f"{w['label_tokens']} launches "
            f"{json.dumps(w['launches'], sort_keys=True)}")
        log(f"work an update: rows {w['rows'] / w['updates']}")
        cell.read_inputs()
        cell.release_program()
        t_check = time.perf_counter()
        chk = cell.check()
        log(f"timing: setup_s {setup_s:.4f} window_s {res['wall_s']:.4f} "
            f"check_s {time.perf_counter() - t_check:.4f}")
        log(f"check: losses {chk['prog_losses']} reference "
            f"{chk['ref_losses']} (the last {cell.cell['accumulation']} the "
            f"window's first update's); worst grad leaf {chk['grad_leaf']}, "
            f"worst change leaf {chk['change_leaf']}, left out "
            f"{chk['left_out']}")
        lim = cell.cell["limits"]
        res["checks"] = {k: (chk[k], lim[k]) for k in CHECKS}
        res["checks"]["input_gap"] = (cell.input_gap, lim["input_gap"])
        res["attempted"] = w["updates"]
        res["failed"] = 0
        return res
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def calibrate(spec, name: str, seeds: List[int], seconds: float,
              device: torch.device, log, control: bool = True) -> list:
    """The program's and the float8 control's numbers on each seed: set-up,
    a window of at least one update, the reference and its control."""
    out = []
    for seed in seeds:
        workdir = Path(tempfile.mkdtemp(prefix="bench_calib_"))
        try:
            cell = TrainCell(spec, name, seed, device, workdir)
            _setup(cell, seconds, False, time.perf_counter(), lambda m: None)
            cell.read_inputs(control=control)
            cell.release_program()
            chk = cell.check(control=control)
            row = {"seed": seed, "input_gap": cell.input_gap,
                   **{k: chk[k] for k in CHECKS + (
                       "grad_leaf", "change_leaf", "prog_losses",
                       "ref_losses")}}
            if control:
                row["control"] = {k: chk["control"][k] for k in CHECKS + (
                    "grad_leaf", "change_leaf", "prog_losses")}
                row["control"]["input_gap"] = cell.input_control
            log(json.dumps(row))
            out.append(row)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return out
