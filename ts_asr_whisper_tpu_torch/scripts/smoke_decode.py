"""One-command accuracy harness: HF DiCoW checkpoint dir + cutset -> tcpWER.

Counterpart of scripts/smoke_decode.py through the port's CLI path
(config.py, decode.py), on the card unless ``--device cpu``:

    python -m ts_asr_whisper_tpu_torch.scripts.smoke_decode \
        --model-dir /path/to/DiCoW_v3_hf_dir \
        --cutset /path/to/librimix_cutset_libri2mix_test-clean.jsonl.gz \
        --output-dir exp/smoke [--diar-cutset hyp.jsonl.gz] \
        [--beam 5 --ctc-weight 0.2 --length-penalty 0.1] [--batch 8] \
        [--device cuda|cuda:N|cpu]

Prints the kernel launches of the decode on one line, then one JSON line
{"tcp_wer": ..., "output_dir": ...}, and writes per-session SegLST +
all_session_wer.csv under --output-dir. The log names the scoring backend
(``scoring=native`` for the C++ tcpWER library).

The model dir is a standard HF export (config.json + model.safetensors +
tokenizer files + optional generation_config.json): e.g. BUT-FIT/DiCoW_v3_3
cloned locally, the hf_export/ directory a fine-tune writes, or the output
of export_dicow.
"""

from __future__ import annotations

import argparse
import json

from .. import kernels


def build_overrides(args) -> list:
    ov = [
        f"model.whisper_model={args.model_dir}",
        "data.train_cutsets=[]",
        "data.dev_cutsets=[]",
        f"data.eval_cutsets=[{args.cutset}]",
        "data.use_timestamps=true",
        "data.train_text_norm=null",
        f"data.eval_text_norm={args.text_norm}",
        "training.decode_only=true",
        f"training.per_device_eval_batch_size={args.batch}",
        f"training.generation_num_beams={args.beam}",
        f"decoding.decoding_ctc_weight={args.ctc_weight}",
        f"decoding.length_penalty={args.length_penalty}",
        f"training.output_dir={args.output_dir}",
        f"training.eval_metrics_list=[{args.metrics}]",
    ]
    if args.diar_cutset:
        ov += ["data.use_diar=true",
               f"data.eval_diar_cutsets=[{args.diar_cutset}]"]
    if args.max_length:
        ov.append(f"training.generation_max_length={args.max_length}")
    if args.dtype:
        ov.append(f"model.dtype={args.dtype}")
    return ov


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", required=True,
                   help="HF checkpoint dir (config.json + model.safetensors)")
    p.add_argument("--cutset", required=True,
                   help="lhotse-style jsonl.gz manifest (Libri2Mix-style)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--diar-cutset", default=None,
                   help="optional diarization-hypothesis cutset")
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--ctc-weight", type=float, default=0.0)
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-length", type=int, default=None)
    p.add_argument("--dtype", default=None, help="e.g. bfloat16 / float32")
    p.add_argument("--text-norm", default="whisper",
                   help="whisper | whisper_nsf | null")
    p.add_argument("--metrics", default="tcp_wer",
                   help="comma-separated: tcp_wer,tcorc_wer,cp_wer,orc_wer")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    from ..__main__ import main as cli_main

    before = dict(kernels.launch_counts)
    metrics = cli_main(["--device", args.device, *build_overrides(args)])
    print("kernel launches: " + json.dumps(
        {k: v - before[k] for k, v in kernels.launch_counts.items()}))
    wers = {k: v for k, v in metrics.items() if k.endswith("_wer")}
    out = {**{k: round(float(v), 4) for k, v in wers.items()},
           "output_dir": args.output_dir}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
