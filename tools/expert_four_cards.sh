#!/bin/bash
# The experts on four cards over NCCL (one rank a card), bf16, --fused all:
# GPT-2 124M with --experts 8 (every other block 8 experts top-2) at its
# automatic expert axis (4: each rank holds 2 experts, one replica) and at
# data 2 x expert 2 (--expert_axis 2), batch 8 a replica, S 1024, 20 steps;
# then Mixtral-8x7B's width (d 4096, GQA 32/8, 8 SwiGLU experts of 14336
# every block) at --expert_axis 4, batch 2, S 2048, --chunked_ce 256, at the
# deepest of depth 10 / 8 / 6 whose train_state_budget fits a card; each
# torchrun a world of its own through tools/torch_world_run.py (rank 0's
# budget line, each rank's peak, the TSV's step times; logs under
# chiprun_out/four/), and the one-card MoE GPT-2 run they are read beside.
# Run from the root of the repo on a machine with four cards:
#   bash tools/expert_four_cards.sh
cd "$(dirname "$0")/.."
mkdir -p chiprun_out/four
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 -c 'from tpudist_torch.csrc import build; build.build_all()' || exit 1
C="--bf16 --fused all --batch_size 8 --experts 8"
M="--arch llama --hidden_dim 4096 --num_heads 32 --num_kv_heads 8
   --ffn_dim 14336 --vocab_size 32000 --rope_theta 1000000 --experts 8
   --bf16 --fused all --batch_size 2 --seq_len 2048 --chunked_ce 256
   --expert_axis 4"
run() {
  job=$1; n=$2; shift 2
  echo "=== $job ($n ranks): $*"
  timeout 600 python3 -m torch.distributed.run --nproc_per_node "$n" \
    --master_port 29600 tools/torch_world_run.py gpt2 "$job" "$@" \
    > "chiprun_out/four/$job.log" 2>&1
  echo "rc $?"
  grep -a "^\[$job\]" "chiprun_out/four/$job.log"
  grep -a -i "error\|Traceback" "chiprun_out/four/$job.log" | tail -5
}
run E4 4 $C --synthetic_tokens 163840
run DE4 4 $C --synthetic_tokens 327680 --expert_axis 2
run E1 1 $C --synthetic_tokens 163840
for d in 10 8 6; do
  line=$(python3 tools/torch_world_run.py budget 4 $M --depth $d)
  echo "depth $d: $line"
  case "$line" in *FITS*) break ;; esac
done
run MX4 4 $M --depth $d --synthetic_tokens 81920
