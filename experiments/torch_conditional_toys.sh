#!/bin/bash
# The conditional editing proofs of the PyTorch port on one card: the class
# toy (synthetic_cond_e2e, 8000 steps), the U-ViT-T2I toy
# (synthetic_t2i_e2e, 16 000) and the SD-UNet T2I toy
# (synthetic_t2i_unet_e2e, 8000) through cli/train_lfm at their configs'
# lengths, each followed by its harness (cli/editing_e2e_cond,
# cli/editing_e2e_t2i), and the SD-UNet attribute toy
# (synthetic_attr_unet_e2e) trained at seeds 4-7, each judged by the port's
# harness at harness seeds 0-7 (experiments/torch_unet_editing_crosscheck.py
# verdict). The seven trainings share the card and its cores, one thread
# each. Run from the repository root on a machine with a card:
#
#     bash experiments/torch_conditional_toys.sh [OUT] [WORK]
#
# OUT (default build/toys_out) gets the logs, the reports and the
# verdicts; WORK (default build/toys) the checkpoints.
OUT=${1:-build/toys_out}
W=${2:-build/toys}
mkdir -p "$OUT" "$W"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' >> "$OUT/card.txt"
python -c 'from uspace_tpu_torch.ops import _build; _build.build()' > "$OUT/build.log" 2>&1
export OMP_NUM_THREADS=1 PYTHONPATH=.
run() {  # name config harness training-seed
  local name=$1 cfg=$2 harness=$3 seed=$4
  local wd=$W/$name
  local sarg=""
  [ -n "$seed" ] && sarg="--seed $seed"
  ( start=$(date +%s)
    python -m uspace_tpu_torch.cli.train_lfm --config "$cfg" --workdir "$wd" $sarg > "$OUT/$name.train.log" 2>&1
    echo "train_rc=$? train_s=$(( $(date +%s) - start ))" >> "$OUT/$name.train.log"
    if [ "$harness" = verdict ]; then
      python experiments/torch_unet_editing_crosscheck.py verdict "port:$wd/ckpts/3000.pt" port "$wd/verdict" --device cuda --seeds 0,1,2,3,4,5,6,7 > "$OUT/$name.verdict.jsonl" 2> "$OUT/$name.verdict.err"
    else
      python -m "uspace_tpu_torch.cli.$harness" --config "$cfg" --workdir "$wd/e2e" --ckpt_path_to_dissect "$wd/ckpts" > "$OUT/$name.e2e.log" 2>&1
      for f in "$wd"/e2e/*; do cp "$f" "$OUT/$name.$(basename "$f")"; done
    fi
    echo "done $(( $(date +%s) - start ))" >> "$OUT/$name.train.log" ) &
}
run cond synthetic_cond_e2e editing_e2e_cond ""
run t2i synthetic_t2i_e2e editing_e2e_t2i ""
run t2i_unet synthetic_t2i_unet_e2e editing_e2e_t2i ""
for s in 4 5 6 7; do run "unet_seed$s" synthetic_attr_unet_e2e verdict "$s"; done
wait
