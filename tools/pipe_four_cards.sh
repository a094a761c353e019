#!/bin/bash
# The pipelined GPT-2 on four cards over NCCL (one rank a card), bf16,
# batch 8 a replica, --fused optimizer: GPT-2 124M at --pipe 4,
# --pipe 2 --tensor 2 and data 2 x pipe 2 (--num_micro 8), and gpt2-large
# (36 x 1280, 20 heads) at --pipe 4, each under GPipe and 1F1B, each
# torchrun a world of its own through tools/torch_world_run.py (rank 0's
# budget line, each rank's peak, the TSV's step times; logs under
# chiprun_out/four/); then the unpipelined one-card runs (--attn xla, the
# pipelined blocks' attention) they are read beside. Where a step goes:
# tools/pipe_four_diag.sh. Run from the root of the repo on a machine with
# four cards:
#   bash tools/pipe_four_cards.sh
cd "$(dirname "$0")/.."
mkdir -p chiprun_out/four
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 -c 'from tpudist_torch.csrc import build; build.build_all()' || exit 1
C="--bf16 --fused optimizer --batch_size 8"
L="--hidden_dim 1280 --depth 36 --num_heads 20"
run() {
  job=$1; n=$2; shift 2
  echo "=== $job ($n ranks): $*"
  timeout 420 python3 -m torch.distributed.run --nproc_per_node "$n" \
    --master_port 29600 tools/torch_world_run.py gpt2 "$job" "$@" \
    > "chiprun_out/four/$job.log" 2>&1
  echo "rc $?"
  grep -a "^\[$job\]" "chiprun_out/four/$job.log"
  grep -a -i "error\|Traceback" "chiprun_out/four/$job.log" | tail -5
}
run P4G 4 $C --synthetic_tokens 163840 --pipe 4 --num_micro 8
run P4O 4 $C --synthetic_tokens 163840 --pipe 4 --num_micro 8 --pipe_schedule 1f1b
run PTG 4 $C --synthetic_tokens 163840 --pipe 2 --tensor 2 --num_micro 8
run PTO 4 $C --synthetic_tokens 163840 --pipe 2 --tensor 2 --num_micro 8 --pipe_schedule 1f1b
run DPG 4 $C --synthetic_tokens 327680 --pipe 2 --num_micro 8
run DPO 4 $C --synthetic_tokens 327680 --pipe 2 --num_micro 8 --pipe_schedule 1f1b
run LG 4 $C $L --synthetic_tokens 163840 --pipe 4 --num_micro 8
run LO 4 $C $L --synthetic_tokens 163840 --pipe 4 --num_micro 8 --pipe_schedule 1f1b
run ONE 1 $C --synthetic_tokens 163840 --attn xla
run ONEL 1 $C $L --synthetic_tokens 163840 --attn xla
