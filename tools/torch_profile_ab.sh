#!/usr/bin/env bash
# A/B profile of the dot_tpu_torch port on one GPU, in one run:
#   bash tools/torch_profile_ab.sh OTHER_TREE [OUT_DIR] [SCENE ...]
# OTHER_TREE is an unpacked copy of another commit (git archive <rev> |
# tar -x -C OTHER_TREE). For each SCENE (any scene of
# dot_tpu_torch.profiling: bar17, bar135, bar17-lbfgs, ..., bar17-admm,
# bar17-admmdd; default bar17)
# python -m dot_tpu_torch.profiling --scene SCENE runs in the order other,
# this, this, other (5 profiled frames for bar17, 3 for bar135, 1 without
# the chrome trace for the two ADMM scenes, whose frames take hundreds of
# iterations), so both
# trees see the same card and its drift. Full logs go to OUT_DIR (default
# output/ab), the chrome traces to a fresh temporary directory that is
# removed at the end; the summary lines go to standard output.
set -u
other=$(cd "$1" && pwd)
here=$(pwd)
out=${2:-output/ab}
shift $(( $# < 2 ? $# : 2 ))
scenes=${*:-bar17}
mkdir -p "$out"
out=$(cd "$out" && pwd)
traces=$(mktemp -d)
trap 'rm -rf "$traces"' EXIT

run() {  # scene tag tree frames
  local sarg=()
  # bar17 is the profiler's default scene (older trees have no --scene)
  [ "$1" != bar17 ] && sarg=(--scene "$1")
  case "$1" in bar17-admm*) sarg+=(--no-trace) ;; esac
  (cd "$3" && python3 -m dot_tpu_torch.profiling "${sarg[@]}" \
      --frames "$4" --out "$traces/$1_$2") > "$out/$1_$2.log" 2>&1
  echo "== $1 $2 (rc $?)"
  grep -E "unwrapped|span split|device kernel time|launches per frame|iterations| ms +[0-9.-]+ self |^  (lbfgs|elem_gradient|chol_inv|block_|admm_local_step|dtw_scatter|w_matvec|w_quad)" \
      "$out/$1_$2.log"
}

for scene in $scenes; do
  frames=5
  [ "$scene" = bar135 ] && frames=3
  case "$scene" in bar17-admm*) frames=1 ;; esac
  run "$scene" other_1 "$other" $frames
  run "$scene" this_1 "$here" $frames
  run "$scene" this_2 "$here" $frames
  run "$scene" other_2 "$other" $frames
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
