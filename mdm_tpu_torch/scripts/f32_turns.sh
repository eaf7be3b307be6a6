#!/bin/bash
# Times the float32 route of this checkout against another (a parent's
# `git archive`, with this checkout's chip_smoke.py and
# mdm_tpu_torch/scripts/gemm_probe.py copied in) on one GPU, in turns:
# other / this / this / other, for each measurement named (by default
# `gemm_probe --f32` (probe_f32), `chip_smoke.py --f32-route` (route) and
# `gemm_probe` (probe_bf16); also attn_fwd and attn_bwd, the bf16
# attention_forward_probe and attention_backward_probe, attn_f32 and
# f32_wide, attention_backward_probe --f32 and --f32-wide), each in a process
# of its own from its tree's root (each tree builds its kernel library
# once). Each run's output goes to OUT/<what>_<label>.txt; the card's name
# and power limit to OUT/card.txt.
#
#   bash mdm_tpu_torch/scripts/f32_turns.sh OTHER_DIR OUT_DIR [WHAT ...]
set -u
ROOT=$(pwd)
OTHER=$(cd "$1" && pwd)
mkdir -p "$2"
OUT=$(cd "$2" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
run() {  # tree label what
  local tree=$1 label=$2 what=$3
  cd "$tree"
  local t0=$SECONDS
  case $what in
    probe_f32) python -m mdm_tpu_torch.scripts.gemm_probe --f32 > "$OUT/${what}_${label}.txt" 2>&1 ;;
    probe_bf16) python -m mdm_tpu_torch.scripts.gemm_probe > "$OUT/${what}_${label}.txt" 2>&1 ;;
    route) python chip_smoke.py --f32-route > "$OUT/${what}_${label}.txt" 2>&1 ;;
    attn_fwd) python -m mdm_tpu_torch.scripts.attention_forward_probe \
                > "$OUT/${what}_${label}.txt" 2>&1 ;;
    attn_bwd) python -m mdm_tpu_torch.scripts.attention_backward_probe \
                > "$OUT/${what}_${label}.txt" 2>&1 ;;
    attn_f32) python -m mdm_tpu_torch.scripts.attention_backward_probe --f32 \
                > "$OUT/${what}_${label}.txt" 2>&1 ;;
    f32_wide) python -m mdm_tpu_torch.scripts.attention_backward_probe --f32-wide \
                > "$OUT/${what}_${label}.txt" 2>&1 ;;
    *) echo "unknown measurement $what"; return 2 ;;
  esac
  echo "$what $label rc=$? $((SECONDS - t0)) s"
  cd "$ROOT"
}
WHATS=("${@:3}")
[ ${#WHATS[@]} -gt 0 ] || WHATS=(probe_f32 route probe_bf16)
for what in "${WHATS[@]}"; do
  run "$OTHER" parent1 $what; run "$ROOT" change1 $what; run "$ROOT" change2 $what
  run "$OTHER" parent2 $what
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader \
  | tee -a "$OUT/card.txt"
