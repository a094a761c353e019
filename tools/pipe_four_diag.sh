#!/bin/bash
# Where a --pipe 4 step of the pipelined GPT-2 goes, on four cards over
# NCCL (bf16, batch 8 a replica, --fused optimizer): the microbatch count
# swept (--num_micro 2 and 4; the TSV's step through
# tools/torch_world_run.py), then one profiled run of --pipe 4 and of
# --pipe 2 --tensor 2 (--num_micro 8) and of one card (--attn xla), every
# rank's trace reduced to its busy share and top kernels
# (chip_smoke.trace_breakdown), then the traces deleted. Logs under
# chiprun_out/diag/. Run from the root of the repo on a machine with four
# cards:
#   bash tools/pipe_four_diag.sh
cd "$(dirname "$0")/.."
mkdir -p chiprun_out/diag
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -1
python3 -c 'from tpudist_torch.csrc import build; build.build_all()' || exit 1
C="--bf16 --fused optimizer --batch_size 8 --synthetic_tokens 163840"
run() {
  job=$1; shift
  echo "=== $job: $*"
  timeout 300 python3 -m torch.distributed.run --nproc_per_node 4 \
    --master_port 29600 tools/torch_world_run.py gpt2 "$job" "$@" \
    > "chiprun_out/diag/$job.log" 2>&1
  echo "rc $?"; grep -a "^\[$job\]" "chiprun_out/diag/$job.log" | grep -v budget
}
run M2 $C --pipe 4 --num_micro 2
run M4 $C --pipe 4 --num_micro 4
prof() {
  job=$1; n=$2; shift 2
  echo "=== profiled $job ($n ranks): $*"
  timeout 300 python3 -m torch.distributed.run --nproc_per_node "$n" \
    --master_port 29601 -m tpudist_torch.train_gpt2 $C "$@" \
    --log_dir "chiprun_out/diag/$job" --JobID "$job" \
    > "chiprun_out/diag/$job.log" 2>&1
  echo "rc $?"
  PYTHONPATH=. python3 - "$job" <<'PY'
import json, sys
from pathlib import Path
import chip_smoke as C
job = sys.argv[1]
for t in sorted(Path(f"chiprun_out/diag/{job}/log_{job}").glob("*.pt.trace.json")):
    w = C.trace_breakdown(t)
    print(job, t.name.split(".")[0][-12:], json.dumps({k: w[k] for k in w if k != "by_name"})[:1500])
    t.unlink()
PY
}
prof PG 4 --pipe 4 --num_micro 8
prof PT 4 --pipe 2 --tensor 2 --num_micro 8
prof P1 1 --attn xla
