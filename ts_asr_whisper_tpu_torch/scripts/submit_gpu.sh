#!/usr/bin/env bash
# GPU job launcher of the PyTorch port, the counterpart of
# scripts/submit_tpu.sh (and of the reference's scripts/submit_slurm.sh,
# 8-GPU torchrun). Every process runs the port's CLI,
# python -m ts_asr_whisper_tpu_torch, which joins the process group from
# torchrun's RANK / LOCAL_RANK / WORLD_SIZE and takes the card cuda:LOCAL_RANK.
#
# Usage:
#   ts_asr_whisper_tpu_torch/scripts/submit_gpu.sh -- +train=dicow_v3 ...
#       one process
#   ts_asr_whisper_tpu_torch/scripts/submit_gpu.sh --local-procs N -- ...
#       torchrun --standalone --nproc-per-node N on this host
#   ts_asr_whisper_tpu_torch/scripts/submit_gpu.sh --hosts h1,h2,... \
#       [--local-procs N] -- ...
#       one torchrun per host over ssh (N processes each, default one per
#       card), rendezvous at the first host's MASTER_PORT (default 29500)
#
# Options before the overrides go to the CLI too (--device, --backend).
# PYTHON overrides the interpreter that runs each process (default: python;
# torchrun starts it as a program, --no-python), TORCHRUN the launcher
# (default: torchrun).
set -euo pipefail

HOSTS=""
LOCAL_PROCS=0
while [[ $# -gt 0 ]]; do
  case "$1" in
    --hosts) HOSTS="$2"; shift 2 ;;
    --local-procs) LOCAL_PROCS="$2"; shift 2 ;;
    --) shift; break ;;
    *) break ;;
  esac
done

PY="${PYTHON:-python}"
TR="${TORCHRUN:-torchrun}"

if [[ -z "$HOSTS" ]]; then
  if [[ "$LOCAL_PROCS" -gt 1 ]]; then
    exec "$TR" --standalone --nproc-per-node "$LOCAL_PROCS" --no-python \
      "$PY" -m ts_asr_whisper_tpu_torch "$@"
  fi
  exec "$PY" -m ts_asr_whisper_tpu_torch "$@"
fi

IFS=',' read -ra HOST_ARR <<< "$HOSTS"
NUM=${#HOST_ARR[@]}
PER_HOST="gpu"
if [[ "$LOCAL_PROCS" -gt 0 ]]; then
  PER_HOST="$LOCAL_PROCS"
fi
ENDPOINT="${HOST_ARR[0]}:${MASTER_PORT:-29500}"
ARGS=$(printf '%q ' "$@")
PIDS=()
for i in "${!HOST_ARR[@]}"; do
  ssh "${HOST_ARR[$i]}" \
    "cd $(printf '%q' "$(pwd)") && $TR --nnodes $NUM \
     --nproc-per-node $PER_HOST --rdzv-backend c10d \
     --rdzv-endpoint $ENDPOINT --no-python $PY -m ts_asr_whisper_tpu_torch \
     $ARGS" &
  PIDS+=($!)
done
STATUS=0
for pid in "${PIDS[@]}"; do
  wait "$pid" || STATUS=$?
done
exit "$STATUS"
