"""Long-form decode cells: the port's ``DecodeRunner.evaluate_dataset``
over a synthetic corpus, timed from the first batch's featurisation to the
end of the batch in flight when ``--seconds`` have passed.

Set-up writes the corpus and a model directory into a temporary directory,
builds the runner from the port's config groups, loads the benchmark's
weights (``reference/dicow.py::make_weights``) and decodes one warm-up batch
of the cell's own shapes through ``DecodeRunner.do_eval``, which also casts
the model to bf16 as the published config asks (``bf16_full_eval``). The
window then runs ``evaluate_dataset`` on the window corpus, whose batch
generator the benchmark wraps to stop at the window's end; scoring is left
out (``compute_longform_metrics`` is replaced for the run).

The decoder's work is fixed by the data: the generation config suppresses
end of text and every timestamp after <|0.00|>, so each window decodes
exactly ``new_tokens`` and every row advances a whole window per seek
iteration. The window corpus holds ``window_batches`` batches, about three
times what a window decodes today; it is never started again, and a window
that reaches its end counts as a work mismatch. The comparison that
decides ``correct`` recomputes, in float32 from the raw inputs, a sample of
the decoded row-windows drawn from the seed: log-mel, STNO, the seek
window, the encoder with its FDDTs, the decoder's logits along the port's
own tokens, and how far each served token lies below the best token that
Whisper's rules leave open there.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline
from benchmark.devicetime import DeviceTrace
from benchmark.reference import dicow as ref
from benchmark.spans import Recorder
from benchmark.traffic import synthetic

NSF = 3000          # mel frames of one 30 s window
WINDOW_S = 30.0
HF_KEYS = ("vocab_size", "num_mel_bins", "d_model", "encoder_layers",
           "decoder_layers", "encoder_attention_heads",
           "decoder_attention_heads", "encoder_ffn_dim", "decoder_ffn_dim",
           "max_source_positions", "max_target_positions")


def suppressed(cfg: dict) -> List[int]:
    """End of text and every timestamp after <|0.00|>."""
    tok = cfg["tokens"]
    return [tok["eos"]] + list(range(tok["timestamp_begin"] + 1,
                                     cfg["vocab_size"]))


def windows_of(duration: float) -> int:
    return math.ceil(synthetic.mel_frames(duration) / NSF)


def batch_work(recs: List[synthetic.Recording], batch_size: int) -> list:
    """(row-windows, seek iterations) of each batch of the plan."""
    rows = synthetic.rows(recs)
    out = []
    for i in range(0, len(rows), batch_size):
        w = [windows_of(r.duration) for r, _ in rows[i: i + batch_size]]
        out.append((sum(w), max(w)))
    return out


class DecodeCell:
    def __init__(self, spec, name: str, seed: int, device: torch.device,
                 workdir: Path):
        self.spec, self.name, self.seed = spec, name, int(seed)
        self.cell = spec.cell(name)
        self.cfg = spec.config(self.cell["config"])
        self.mix = spec.traffic(self.cell["traffic"])
        self.device = torch.device(device)
        self.workdir = Path(workdir)
        self.bs = self.cell["batch_size"]
        self.prompt = 3
        self.records: list = []

    # -- set-up -----------------------------------------------------------
    def write_inputs(self) -> None:
        c = self.cell
        # one batch of the window's own template: the same rows, buckets
        # and recording lengths as every window batch
        self.warm_recs = synthetic.plan_batches(self.mix, 1, self.seed, "w")
        self.win_recs = synthetic.plan_batches(
            self.mix, c["window_batches"], self.seed, "b")
        data = self.workdir / "data"
        self.warm_manifest = synthetic.write_corpus(
            data, self.warm_recs, self.seed, "warmup")
        self.win_manifest = synthetic.write_corpus(
            data, self.win_recs, self.seed, "window")
        model_dir = self.workdir / "model"
        model_dir.mkdir(parents=True, exist_ok=True)
        with open(model_dir / "config.json", "w") as f:
            json.dump({k: self.cfg[k] for k in HF_KEYS}, f)
        with open(model_dir / "generation_config.json", "w") as f:
            json.dump({"suppress_tokens": suppressed(self.cfg),
                       "return_timestamps": True}, f)
        self.model_dir = model_dir
        self.plan = batch_work(self.win_recs, self.bs)
        self.rows = synthetic.rows(self.win_recs)

    def build(self) -> None:
        from ts_asr_whisper_tpu_torch import decode as decode_mod
        from ts_asr_whisper_tpu_torch.config import load_config

        c = self.cell
        overrides = list(c["port_overrides"]) + list(
            self.cfg["port_overrides"]) + [
            f"model.whisper_model={self.model_dir}",
            f"data.eval_cutsets=[{self.warm_manifest},{self.win_manifest}]",
            "data.train_cutsets=[]", "data.dev_cutsets=[]",
            f"training.per_device_eval_batch_size={self.bs}",
            f"training.generation_max_length={self.prompt + c['new_tokens']}",
            f"training.output_dir={self.workdir / 'out'}",
            "training.save_visualizations=false",
            "training.mesh_shape=[1]"]
        cfg = load_config(overrides)
        decode_mod.no_tf32()
        self.decode_mod = decode_mod
        self.runner = decode_mod.DecodeRunner(cfg, self.device)
        tok = self.runner.container.tokenizer
        want = self.cfg["tokens"]
        got = {"eos": tok.eos_token_id, "timestamp_begin": tok.timestamp_begin,
               "no_timestamps": tok.no_timestamps_token_id}
        if any(got[k] != want[k] for k in got):
            raise ValueError(f"the port's token ids {got} are not the "
                             f"configuration's {want}")
        self.load_weights()

    def load_weights(self) -> None:
        w = ref.make_weights(self.cfg, self.seed, self.device)
        self.runner.container.model.load_state_dict(w, strict=True)
        del w

    def warm_up(self) -> None:
        """One batch of the cell's own shapes (the same slots as every
        window batch, so the same buckets), through ``do_eval``."""
        self._stub_scoring()
        ds = self.runner.eval_datasets["warmup"]
        self.runner.do_eval({"warmup": ds})
        self._sync()

    def _stub_scoring(self) -> None:
        if getattr(self, "_scoring", None) is None:
            self._scoring = self.decode_mod.compute_longform_metrics
            self.decode_mod.compute_longform_metrics = lambda *a, **k: {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ---------------------------------------------------------
    def run_window(self, seconds: float, trace: bool) -> dict:
        from ts_asr_whisper_tpu_torch import kernels
        from ts_asr_whisper_tpu_torch.decoding import longform
        from ts_asr_whisper_tpu_torch.ops import attention

        model = self.runner.container.model
        rec = Recorder(sync=self._sync)
        rec.on = trace
        self.records = []
        per_batch: List[list] = []
        flash_bounds: List[float] = []
        state = {"batch": None, "iter": 0, "t0": None, "t_end": None,
                 "n": 0, "steps": 0, "exhausted": False}
        limit_batches = self.cell["trace_batches"] if trace else None
        orig_batches = self.decode_mod.eval_batches

        def timed_batches(dataset, collate, bs, **kw):
            # the corpus is never started again: a window that reaches its
            # end stops there, and the check counts that as a work mismatch
            it = orig_batches(dataset, collate, bs, **kw)
            while True:
                if state["t0"] is None:
                    state["t0"] = time.perf_counter()
                elif (limit_batches is not None
                      and state["n"] >= limit_batches) or (
                        limit_batches is None and
                        time.perf_counter() - state["t0"] >= seconds):
                    break
                with rec.span("host_data"):
                    item = next(it, None)
                if item is None:
                    state["exhausted"] = True
                    break
                state["batch"], state["iter"] = item[0], 0
                state["n"] += 1
                yield item
            state["t_end"] = time.perf_counter()

        def on_longform(args, kwargs, out):
            per_batch.append((state["batch"], out.windows_decoded,
                              time.perf_counter()))

        def on_slice(args, kwargs, out):
            self.records.append({"batch": state["batch"],
                                 "iter": state["iter"],
                                 "meta": np.array(args[2])})
            state["iter"] += 1

        def on_decode(args, kwargs, out):
            self.records[-1]["tokens"] = out.sequences

        probe, probe_ids = self.probe(), self.probe_ids()

        def on_logits(args, kwargs, out):
            # the logits of the probe's ids at every step, on the device
            self.records[-1].setdefault("logits", []).append(
                out[:, probe_ids])

        def on_encoder(mod, args, out):
            # a fixed random projection of the encoder's output, kept on
            # the device for the check (one small product a seek iteration)
            self.records[-1]["enc"] = out.float() @ probe

        def count_step(fn):
            def wrapped(*a, **k):
                state["steps"] += 1
                return fn(*a, **k)
            return wrapped

        def on_flash(args, kwargs, out):
            q = args[0]
            b, h, t, d = q.shape
            flash_bounds.append(roofline.bound_s(
                *roofline.flash_fwd(b * h, t, d, q.element_size()),
                _dtype_name(q.dtype)))

        self.decode_mod.eval_batches = timed_batches
        rec.wrap(self.decode_mod, "longform_generate", "seek_loop",
                 after=on_longform)
        rec.wrap(longform, "slice_windows", "slice", after=on_slice)
        rec.wrap(longform, "greedy_decode", "decode_loop", after=on_decode)
        rec.hook_module(model.model.encoder, "encoder")
        enc_hook = model.model.encoder.register_forward_hook(on_encoder)
        orig_step = model.decoder.decoder_cached
        model.decoder.decoder_cached = count_step(orig_step)
        rec.wrap(model.decoder, "lm_logits", "lm_logits", after=on_logits)
        if trace:
            rec.wrap(attention, "flash_mha_fwd", "flash_fwd",
                     after=on_flash)
        launches0 = dict(kernels.launch_counts)
        windows0 = self.runner.windows_decoded
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._sync()
        tr = DeviceTrace() if trace else contextlib.nullcontext()
        try:
            with tr:
                self.runner.evaluate_dataset(
                    self.runner.eval_datasets["window"],
                    str(self.workdir / "out" / "window"))
        finally:
            self.decode_mod.eval_batches = orig_batches
            del model.decoder.decoder_cached
            enc_hook.remove()
            rec.restore()
            del model.decoder.lm_logits
        self._sync()
        wall = state["t_end"] - state["t0"]
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        greedy_calls = sum(1 for r in self.records if "tokens" in r)
        work = {
            "batches": state["n"],
            "row_windows": self.runner.windows_decoded - windows0,
            "seek_iterations": len(self.records),
            "decode_calls": greedy_calls,
            "decoder_steps": state["steps"] - greedy_calls,
            "launches": {k: v - launches0.get(k, 0)
                         for k, v in kernels.launch_counts.items()
                         if v - launches0.get(k, 0)},
        }
        batch_ids = [b for b, _, _ in per_batch]
        audio_s = sum(r.duration for b in batch_ids
                      for r in self.win_recs[b * len(self.mix[
                          "batch_template"]):(b + 1) * len(
                          self.mix["batch_template"])])
        out = {"wall_s": wall, "work": work, "per_batch": per_batch,
               "t0": state["t0"], "exhausted": state["exhausted"],
               "memory_peak_bytes": int(peak),
               "recording_audio_s": audio_s,
               "decode_rtfx": WINDOW_S * work["row_windows"] / wall}
        if trace:
            out["trace"] = tr.result()
            out["ctx"] = {"rec": rec, "trace": out["trace"], "work": work,
                          "flash_fwd_bounds": flash_bounds,
                          "flops": self.window_flops(work),
                          "wall_s": wall}
        return out

    def probe(self) -> torch.Tensor:
        """(d, 8) projection from the seed that the check reads the
        encoder's output through."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed % 2 ** 63 + 1)
        d = self.cfg["d_model"]
        return torch.randn(d, 8, generator=g, device=self.device) / d ** 0.5

    def probe_ids(self) -> torch.Tensor:
        """64 vocabulary ids from the seed whose logits the check reads."""
        g = torch.Generator(device="cpu")
        g.manual_seed(self.seed % 2 ** 63 + 2)
        ids = torch.randperm(self.cfg["vocab_size"], generator=g)[:64]
        return ids.sort().values.to(self.device)

    def window_flops(self, work: dict) -> float:
        """Model FLOPs of the window's row-windows: the encoder, the
        cross-attention k/v and the decoder positions each needs."""
        c = self.cfg
        dec = sum(roofline.decoder_token_flops(c, p)
                  for p in range(self.prompt + self.cell["new_tokens"] - 1))
        per = (roofline.encoder_window_flops(c) + roofline.cross_kv_flops(c)
               + dec)
        return work["row_windows"] * per

    # -- correctness ----------------------------------------------------------
    def expected_mismatch(self, res: dict) -> int:
        """Batches whose row-windows differ from what the plan fixes,
        decodes not ``new_tokens`` long, and one more where the window
        reached the corpus's end."""
        bad = sum(1 for b, n, _ in res["per_batch"] if n != self.plan[b][0])
        bad += sum(1 for r in self.records if "tokens" in r
                   and r["tokens"].shape[1]
                   != self.prompt + self.cell["new_tokens"])
        return bad + int(res["exhausted"])

    def sample(self) -> List[tuple]:
        """(record, bucket position) of row-windows drawn from the seed
        among those decoded in the window; a bucket's padded duplicates are
        left out."""
        cands = []
        for i, r in enumerate(self.records):
            seen = set()
            for j, row in enumerate(r["meta"][0].tolist()):
                if row not in seen:
                    seen.add(row)
                    cands.append((i, j))
        rng = np.random.default_rng([self.seed, 7])
        k = min(self.cell["check_row_windows"], len(cands))
        pick = rng.choice(len(cands), size=k, replace=False)
        return [cands[int(p)] for p in sorted(pick)]

    def release_program(self) -> None:
        """Free the program's state before the reference runs."""
        picked = self.sample()
        self.checked = []
        for i, j in picked:
            r = self.records[i]
            self.checked.append({
                "batch": r["batch"], "iter": r["iter"],
                "row": int(r["meta"][0][j]),
                "tokens": r["tokens"][j].cpu(), "enc": r["enc"][j].cpu(),
                "logits": predicting(r["logits"], j).cpu()})
        self.records = []
        self.decode_mod.compute_longform_metrics = self._scoring
        self._scoring = None
        self.runner = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> dict:
        """Over the sampled row-windows: the widest relative gap of the
        encoder's output (through the seed's projection) from the
        reference's, and the widest gap of a served token below the
        reference's best open logit; with ``control``, the same for float8
        products (its encoder, and the token it puts first)."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._check(control)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    @torch.no_grad()
    def _check(self, control: bool) -> dict:
        w = ref.make_weights(self.cfg, self.seed, self.device)
        model = ref.Reference(self.cfg, w)
        low = ref.Reference(self.cfg, w, ref.fp8_matmul) if control else None
        tok = self.cfg["tokens"]
        sup = torch.tensor(suppressed(self.cfg), device=self.device)
        feats: Dict[str, tuple] = {}
        gaps, ctl, n_tokens = [], [], 0
        enc_gaps, enc_ctl, logit_gaps, logit_ctl = [], [], [], []
        probe, ids = self.probe(), self.probe_ids()
        pos = slice(self.prompt - 1, self.prompt - 1 + self.cell["new_tokens"])
        for s in self.checked:
            rec, spk = self.rows[s["batch"] * self.bs + s["row"]]
            if rec.id not in feats:
                samples = synthetic.read_wav(rec.path)
                feats = {rec.id: (*ref.log_mel(samples, self.cfg[
                    "num_mel_bins"], self.device), samples.shape[0])}
            mel, valid, n_samples = feats[rec.id]
            st = ref.stno(rec.turns, spk, sorted(rec.speakers), n_samples)
            f, stw = ref.window(mel, valid, st, NSF * s["iter"])
            tokens = s["tokens"].to(self.device)
            enc = model.encoder(f, stw)
            enc_gaps.append(rel_gap(s["enc"].to(self.device), enc @ probe))
            logits = model.decoder_logits(tokens, enc)
            logit_gaps.append(rel_gap(s["logits"].to(self.device),
                                      logits[pos][:, ids]))
            allowed = ref.allowed_mask(logits, tokens, self.prompt, tok, sup)
            g = ref.served_gaps(logits, tokens, self.prompt, allowed)
            gaps.append(float(g.max()))
            n_tokens += g.numel()
            if low is not None:
                low_enc = low.encoder(f, stw)
                enc_ctl.append(rel_gap(low_enc @ probe, enc @ probe))
                ll = low.decoder_logits(tokens, low_enc)
                logit_ctl.append(rel_gap(ll[pos][:, ids], logits[pos][:, ids]))
                ctl.append(float(ref.control_gaps(
                    logits, ll, tokens, self.prompt, allowed).max()))
        out = {"widest_gap": max(gaps) if gaps else math.inf,
               "encoder_gap": max(enc_gaps) if enc_gaps else math.inf,
               "logit_gap": max(logit_gaps) if logit_gaps else math.inf,
               "gaps": gaps, "encoder_gaps": enc_gaps,
               "logit_gaps": logit_gaps,
               "tokens_compared": n_tokens}
        if control:
            out["control_gap"] = max(ctl) if ctl else math.nan
            out["control_encoder_gap"] = max(enc_ctl) if enc_ctl \
                else math.nan
            out["control_logit_gap"] = max(logit_ctl) if logit_ctl \
                else math.nan
            out["control_gaps"] = ctl
        return out


def predicting(calls: List[torch.Tensor], j: int) -> torch.Tensor:
    """(new tokens, ids) logits of bucket row ``j`` that chose each
    generated token, from one greedy decode's ``lm_logits`` calls: the
    prompt's last position, the start-of-transcript position (no-speech),
    then one a step, the last step's unused."""
    return torch.stack([calls[0][j]] + [c[j] for c in calls[2:-1]])


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Frobenius norm of a - b over that of b."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _dtype_name(dtype: torch.dtype) -> str:
    return {torch.bfloat16: "bfloat16", torch.float16: "float16",
            torch.float32: "float32"}[dtype]


def run(spec, name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log) -> dict:
    """One run of a decode cell: set-up, the window, the check."""
    workdir = Path(tempfile.mkdtemp(prefix="bench_decode_"))
    try:
        cell = DecodeCell(spec, name, seed, device, workdir)
        marks = [("start", time.perf_counter() - t_start)]
        for step in (cell.write_inputs, cell.build, cell.warm_up):
            step()
            marks.append((step.__name__, time.perf_counter() - t_start))
        setup_s = marks[-1][1]
        log("set-up: " + " ".join(f"{n} {t:.3f}" for n, t in marks))
        res = cell.run_window(seconds, trace)
        res["setup_s"] = setup_s
        w = res["work"]
        log(f"work: batches {w['batches']} row_windows {w['row_windows']} "
            f"seek_iterations {w['seek_iterations']} decode_calls "
            f"{w['decode_calls']} decoder_steps {w['decoder_steps']} "
            f"launches {json.dumps(w['launches'], sort_keys=True)}")
        n = max(w["batches"], 1)
        log(f"work a batch: row_windows {w['row_windows'] / n} "
            f"seek_iterations {w['seek_iterations'] / n} decoder_steps "
            f"{w['decoder_steps'] / n}")
        ends = [t for _, _, t in res["per_batch"]]
        log("batch walls: " + " ".join(
            f"{b - a:.4f}" for a, b in zip([res["t0"]] + ends, ends)))
        log(f"recording audio: {res['recording_audio_s']:.2f} s in "
            f"{res['wall_s']:.4f} s = "
            f"{res['recording_audio_s'] / res['wall_s']:.4f} audio-s/s")
        mismatch = cell.expected_mismatch(res)
        cell.release_program()
        t_check = time.perf_counter()
        chk = cell.check()
        log(f"timing: setup_s {setup_s:.4f} window_s {res['wall_s']:.4f} "
            f"check_s {time.perf_counter() - t_check:.4f}")
        lim = cell.cell["limits"]
        res["checks"] = {"logit_gap": (chk["logit_gap"], lim["logit_gap"]),
                         "served_gap": (chk["widest_gap"],
                                        lim["served_gap"]),
                         "work_mismatch": (mismatch, lim["work_mismatch"])}
        res["attempted"] = w["row_windows"]
        res["failed"] = 0
        log(f"check: {chk['tokens_compared']} served tokens of "
            f"{len(chk['gaps'])} row-windows, gaps "
            f"{[round(g, 5) for g in chk['gaps']]}, logit gaps "
            f"{[round(g, 5) for g in chk['logit_gaps']]}; not compared: "
            f"encoder gap {chk['encoder_gap']:.5f}")
        return res
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def calibrate(spec, name: str, seeds: List[int], seconds: float,
              device: torch.device, log, control: bool = True) -> List[dict]:
    """The program's and the control's readings on each seed, in one
    process: a short window at the cell's own load, then the reference and
    its float8 control over the same sample."""
    out = []
    for seed in seeds:
        workdir = Path(tempfile.mkdtemp(prefix="bench_calib_"))
        try:
            cell = DecodeCell(spec, name, seed, device, workdir)
            cell.write_inputs()
            cell.build()
            cell.warm_up()
            res = cell.run_window(seconds, False)
            mismatch = cell.expected_mismatch(res)
            cell.release_program()
            chk = cell.check(control=control)
            row = {"seed": seed, "served_gap": chk["widest_gap"],
                   "encoder_gap": chk["encoder_gap"],
                   "logit_gap": chk["logit_gap"],
                   "gaps": chk["gaps"], "encoder_gaps": chk["encoder_gaps"],
                   "work_mismatch": mismatch,
                   "row_windows": res["work"]["row_windows"]}
            if control:
                row["control"] = {"served_gap": chk["control_gap"],
                                  "encoder_gap": chk["control_encoder_gap"],
                                  "logit_gap": chk["control_logit_gap"],
                                  "gaps": chk["control_gaps"]}
            log(json.dumps(row))
            out.append(row)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return out
